"""Per-layer probes, the counterpart of ``repro/launch/probes.py``.

``repro`` needs them because XLA's ``cost_analysis()`` counts a
``lax.scan`` body once, and every LM there scans over its layers. The
port runs eagerly: every layer and every recurrence step is dispatched,
and so counted, in the whole step (the dry run's ``gate``). A probe here
is one layer's body with ``repro``'s ``name`` and ``mult`` (the trip count
less one), a breakdown of the step, never a term to add to it.

Probes use einsum attention (banded where the arch has a window), as
``repro``'s do, and the recurrent families their plain scans.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, Family, ShapeConfig
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.encdec import ENC_LEN
from repro_torch.models.registry import Model
from repro_torch.sharding import spmd
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class Probe:
    name: str
    mult: int
    fn: Callable
    args: tuple             # tensors without data (fake or meta)
    shardings: Optional[tuple]   # logical-axis trees matching args
    # the args that are a self-attention K / V cache: the sharded decode
    # keeps their sequence's "model" block (flash decode)
    cache_args: tuple = ()


# params subtrees of one layer slice and their leading stack axes left
# after the layer axis is dropped (a VLM block keeps its per-super axis)
PROBE_STACKS = {"layers": 0, "enc_layers": 0, "dec_layers": 0,
                "super": {"blocks": 1, "cross": 0}}


def _layer_params(model: Model, key: str, device):
    """One slice of params[key] (its leading L axis dropped), on
    ``device``."""
    full = model.init(torch.Generator(), device)[key]
    return tree_map(lambda t: t[0], full)


def _layer_logical(model: Model, key: str, zero_stage: int = 3):
    """Logical tree of one slice (the leading None axis dropped);
    zero_stage < 3 strips the "fsdp" factor (params replicated over
    data)."""
    def fix(tree):
        if isinstance(tree, dict):
            return {k: fix(v) for k, v in tree.items()}
        ax = tree[1:]
        if zero_stage < 3:
            ax = tuple(None if a == "fsdp" else a for a in ax)
        return ax
    return fix(model.param_logical()[key])


X_LOGICAL = ("batch", "seq_sp", None)


def _grad_wrap(fn, remat):
    """fwd+bwd probe: the gradients of sum(output) with respect to (x, the
    layer's params), as ``repro``'s ``jax.grad`` of its probe; ``remat``
    checkpoints the body (``torch.utils.checkpoint``, its forward run
    again in the backward, as ``jax.checkpoint`` does). ``view`` turns the
    leaves into what the body reads (the sharded runner's gathered
    params)."""
    def probe(x, lp, *rest, view=lambda p: p):
        x = x.detach().requires_grad_(True)
        lp = tree_map(lambda t: t.detach().requires_grad_(True), lp)

        def body(x, lp):
            return fn(x, view(lp), *rest)
        if remat:
            out = checkpoint(spmd.checkpointed(body), x, lp,
                             use_reentrant=False)
        else:
            out = body(x, lp)
        leaves = [x] + tree_leaves(lp)
        return torch.autograd.grad(out.float().sum(), leaves,
                                   allow_unused=True)
    probe.takes_view = True
    return probe


def _const(v: int):
    """A scalar position as a constant (a fake tensor made by
    ``torch.tensor`` keeps its value, which the decode paths read)."""
    return torch.tensor(v, dtype=torch.int32)


# ------------------------------------------------------------ per family
def probes_for(model: Model, shape: ShapeConfig, *,
               compute_dtype=torch.bfloat16, attn_impl: str = "einsum",
               remat=True, microbatches: int = 1, zero_stage: int = 3,
               device="cpu") -> List[Probe]:
    """``repro``'s probes of a cell: with gradient-accumulation
    microbatching the probes run at B / microbatches and multiplicities
    scale by ``microbatches``. Build them under a ``FakeTensorMode`` (or
    with ``device="meta"``) at full size."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    mb = microbatches if kind in ("train", "prefill") else 1
    B = B // mb
    D = cfg.d_model
    cd = compute_dtype
    probes: List[Probe] = []

    def x_(b, s):
        return torch.empty((b, s, D), dtype=cd, device=device)

    def mult(trips: int) -> int:
        return mb * trips - 1

    def wrap(fwd):
        return _grad_wrap(fwd, remat) if kind == "train" else fwd

    # positions are made from the rows a call is given (a rank of the
    # sharded runner holds its own rows; with the dense / MoE rows
    # over "model", its block of the sequence: ``spmd.seq_rows``)
    def seq_positions(x, n):
        lo, hi = spmd.seq_rows(x.shape[1]) if n == x.shape[1] else (0, n)
        return torch.arange(lo, hi, device=x.device).expand(x.shape[0],
                                                            hi - lo)

    pos = _const(S - 1)

    def dec_positions(x):
        return torch.full((x.shape[0], 1), S - 1, dtype=torch.int64,
                          device=x.device)

    if cfg.family in (Family.DENSE, Family.MOE):
        lp = _layer_params(model, "layers", device)
        lp_log = _layer_logical(model, "layers", zero_stage)
        if kind in ("train", "prefill"):
            def fwd(x, lp):
                return transformer._layer_apply(cfg, lp, x,
                                                seq_positions(x, x.shape[1]),
                                                attn_impl)[0]
            probes.append(Probe("layer", mult(cfg.num_layers), wrap(fwd),
                                (x_(B, S), lp), (X_LOGICAL, lp_log)))
        else:
            kv_log = model.cache_logical()["k"][1:]
            if transformer._is_mla(cfg):
                ck = torch.empty((B, S, 1, transformer._mla_dims(
                    cfg).latent_dim), dtype=cd, device=device)

                def dec(x, lp, ck):
                    return transformer._decode_layer_mla(
                        cfg, lp, x, ck, pos, dec_positions(x))
                probes.append(Probe("layer", mult(cfg.num_layers), dec,
                                    (x_(B, 1), lp, ck),
                                    (X_LOGICAL, lp_log, kv_log)))
            else:
                kv, hd = cfg.num_kv_heads, cfg.head_dim

                def dec(x, lp, ck, cv):
                    return transformer._decode_layer(cfg, lp, x, ck, cv, pos,
                                                     dec_positions(x))
                probes.append(Probe(
                    "layer", mult(cfg.num_layers), dec,
                    (x_(B, 1), lp,
                     torch.empty((B, S, kv, hd), dtype=cd, device=device),
                     torch.empty((B, S, kv, hd), dtype=cd, device=device)),
                    (X_LOGICAL, lp_log, kv_log, kv_log), (2, 3)))

    elif cfg.family == Family.VLM:
        sp = _layer_params(model, "super", device)
        sp_log = _layer_logical(model, "super", zero_stage)
        n_super = cfg.num_layers // cfg.cross_attn_every
        img = torch.empty((B, cfg.num_image_tokens, D), dtype=cd,
                          device=device)
        img_log = ("batch", None, None)
        if kind in ("train", "prefill"):
            def fwd(x, sp, image):
                positions = seq_positions(x, S)
                return transformer._super_apply(
                    cfg, sp, x, image,
                    lambda _, lp, x: transformer._layer_apply(
                        cfg, lp, x, positions, attn_impl)[0])
            probes.append(Probe("super_layer", mult(n_super), wrap(fwd),
                                (x_(B, S), sp, img),
                                (X_LOGICAL, sp_log, img_log)))
        else:
            kv, hd = cfg.num_kv_heads, cfg.head_dim
            per = cfg.cross_attn_every

            def dec(x, sp, ck, cv, image):
                positions = dec_positions(x)
                return transformer._super_apply(
                    cfg, sp, x, image,
                    lambda i, lp, x: transformer._decode_layer(
                        cfg, lp, x, ck[i], cv[i], pos, positions))
            kv_log = (None,) + model.cache_logical()["k"][1:]
            probes.append(Probe(
                "super_layer", mult(n_super), dec,
                (x_(B, 1), sp,
                 torch.empty((per, B, S, kv, hd), dtype=cd, device=device),
                 torch.empty((per, B, S, kv, hd), dtype=cd, device=device),
                 img),
                (X_LOGICAL, sp_log, kv_log, kv_log, img_log), (2, 3)))

    elif cfg.family == Family.ENCDEC:
        enc_lp = _layer_params(model, "enc_layers", device)
        enc_log = _layer_logical(model, "enc_layers", zero_stage)
        dec_lp = _layer_params(model, "dec_layers", device)
        dec_log = _layer_logical(model, "dec_layers", zero_stage)
        Se = ENC_LEN
        if kind in ("train", "prefill"):
            def enc_fwd(x, lp):
                return encdec._enc_layer(cfg, lp, x, seq_positions(x, Se),
                                         attn_impl)

            def dec_fwd(x, lp, enc_out):
                return encdec._dec_layer(cfg, lp, x, seq_positions(x, S),
                                         enc_out, seq_positions(x, Se),
                                         attn_impl)
            probes.append(Probe("enc_layer", mult(cfg.encoder_layers),
                                wrap(enc_fwd), (x_(B, Se), enc_lp),
                                (X_LOGICAL, enc_log)))
            probes.append(Probe("dec_layer", mult(cfg.num_layers),
                                wrap(dec_fwd), (x_(B, S), dec_lp, x_(B, Se)),
                                (X_LOGICAL, dec_log, X_LOGICAL)))
        else:
            kv, hd = cfg.num_kv_heads, cfg.head_dim

            def dec(x, lp, ck, cv, xk, xv):
                return encdec._decode_layer(cfg, lp, x, ck, cv, xk, xv, pos,
                                            dec_positions(x),
                                            seq_positions(x, Se))
            cl = model.cache_logical()
            kv_log, xkv_log = cl["k"][1:], cl["xk"][1:]
            probes.append(Probe(
                "dec_layer", mult(cfg.num_layers), dec,
                (x_(B, 1), dec_lp,
                 torch.empty((B, S, kv, hd), dtype=cd, device=device),
                 torch.empty((B, S, kv, hd), dtype=cd, device=device),
                 torch.empty((B, Se, kv, hd), dtype=cd, device=device),
                 torch.empty((B, Se, kv, hd), dtype=cd, device=device)),
                (X_LOGICAL, dec_log, kv_log, kv_log, xkv_log, xkv_log),
                (2, 3)))

    elif cfg.family == Family.SSM:
        lp = _layer_params(model, "layers", device)
        lp_log = _layer_logical(model, "layers", zero_stage)
        H, N = cfg.num_heads, cfg.head_dim
        if kind in ("train", "prefill"):
            def fwd(x, lp):
                return ssm._layer_apply(cfg, lp, x, None, "scan")[0]
            probes.append(Probe("layer", mult(cfg.num_layers), wrap(fwd),
                                (x_(B, S), lp), (X_LOGICAL, lp_log)))
        else:
            f32 = dict(dtype=torch.float32, device=device)
            st = {"S": torch.empty((B, H, N, N), **f32),
                  "x_tm": torch.empty((B, D), **f32),
                  "x_cm": torch.empty((B, D), **f32)}
            st_log = {"S": ("batch", "heads", None, None),
                      "x_tm": ("batch", None), "x_cm": ("batch", None)}

            def dec(x, lp, st):
                return ssm._layer_apply(cfg, lp, x, st, "scan")
            probes.append(Probe("layer", mult(cfg.num_layers), dec,
                                (x_(B, 1), lp, st),
                                (X_LOGICAL, lp_log, st_log)))

    elif cfg.family == Family.HYBRID:
        lp = _layer_params(model, "layers", device)
        lp_log = _layer_logical(model, "layers", zero_stage)
        kv, hd, Nst = cfg.num_kv_heads, cfg.head_dim, cfg.ssm_state
        if kind in ("train", "prefill"):
            def fwd(x, lp):
                return hybrid._layer_apply(cfg, lp, x,
                                           seq_positions(x, x.shape[1]),
                                           attn_impl, "scan")
            probes.append(Probe("layer", mult(cfg.num_layers), wrap(fwd),
                                (x_(B, S), lp), (X_LOGICAL, lp_log)))
        else:
            W = min(cfg.window, S)
            f32 = dict(dtype=torch.float32, device=device)

            def dec(x, lp, ck, cv, spos, hst, conv):
                return hybrid._decode_layer(
                    cfg, lp, x, ck, cv, spos, {"h": hst, "conv": conv}, pos,
                    dec_positions(x), ssm_impl="scan")
            probes.append(Probe(
                "layer", mult(cfg.num_layers), dec,
                (x_(B, 1), lp,
                 torch.empty((B, W, kv, hd), dtype=cd, device=device),
                 torch.empty((B, W, kv, hd), dtype=cd, device=device),
                 torch.empty((B, W), dtype=torch.int32, device=device),
                 torch.empty((B, D, Nst), **f32),
                 torch.empty((B, hybrid.CONV_K - 1, D), **f32)),
                (X_LOGICAL, lp_log,
                 ("batch", None, "kv_heads", None),
                 ("batch", None, "kv_heads", None),
                 ("batch", None), ("batch", "d_ff", None),
                 ("batch", None, None))))
    else:
        raise ValueError(cfg.family)

    # the chunked-CE head: one chunk's checkpointed CE and its gradients
    if kind == "train":
        from repro_torch.launch import steps as _steps
        chunk = min(_steps.CE_CHUNK, S)
        n_chunks = S // chunk
        if mb * n_chunks > 1:
            tied = cfg.tie_embeddings or cfg.family == Family.ENCDEC
            Vp = cfg.padded_vocab
            w = torch.empty((Vp, D) if tied else (D, Vp),
                            dtype=torch.float32, device=device)
            w_log = ("vocab", "fsdp") if tied else ("fsdp", "vocab")
            vocab = cfg.vocab_size

            def head_probe(x_c, w, labels_c, view=lambda p: p):
                x_c = x_c.detach().requires_grad_(True)
                w = w.detach().requires_grad_(True)

                def body(x, ww):
                    ww = view(ww)
                    split = spmd.tp_split(ww) is not None
                    labels = labels_c
                    if spmd.sp_on() and not split:     # the rank's rows
                        labels = labels[:, slice(*spmd.seq_rows(x.shape[1]))]
                    return _steps.head_ce_chunk(x, ww, labels, vocab, tied,
                                                split)
                out = checkpoint(spmd.checkpointed(body), x_c, w,
                                 use_reentrant=False)
                return torch.autograd.grad(out, (x_c, w))
            head_probe.takes_view = True
            probes.append(Probe(
                "head_ce", mult(n_chunks), head_probe,
                (x_(B, chunk), w,
                 torch.empty((B, chunk), dtype=torch.int32, device=device)),
                (X_LOGICAL, w_log, ("batch", None))))
    return probes


# ------------------------------------------------- analytic recurrence extras
def recurrence_extra(cfg: ArchConfig, shape: ShapeConfig, kind: str) -> dict:
    """FLOPs/bytes of per-token recurrent scans (counted once by HLO, so added
    analytically for train/prefill; decode probes are scan-free and exact)."""
    if kind == "decode" or cfg.family not in (Family.SSM, Family.HYBRID):
        return {"flops": 0.0, "bytes": 0.0}
    tokens = shape.tokens
    mult = 3.0 if kind == "train" else 1.0   # fwd+recompute+bwd
    if cfg.family == Family.SSM:
        H, N = cfg.num_heads, cfg.head_dim
        per_tok = 10.0 * H * N * N           # kv outer + bonus + read + decay-update
    else:
        per_tok = 8.0 * cfg.d_model * cfg.ssm_state
    flops = mult * per_tok * tokens * cfg.num_layers
    # recurrent state stays in VMEM in the chunked kernel; HBM extra ~ 0
    return {"flops": flops, "bytes": 0.0}
