"""RWKV6 "Finch", the attention-free LM with a data-dependent per-channel
decay. Counterpart of ``repro/models/ssm.py``: the same parameter names and
layer-stacked shapes, the same operation order; a Python loop over layers
takes the place of ``lax.scan``, and the decode state is written into the
cache in place.

Time mix: ``y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)``, ``S_t = diag(w_t)
S_{t-1} + k_t v_t^T`` with ``w_t = exp(-exp(w0 + lora_w(x_w)))`` and
DDLerp token-shift mixing for r / k / v / w / g; channel mix: a
squared-relu MLP with token shift. Heads: cfg.num_heads x head_dim; state
per layer (B, H, N, N).

The wkv recurrence runs through ``scan_impl``: 'pallas' is
``kernels.ops.wkv6`` (the Hopper kernel on a CUDA tensor), 'scan' the plain
recurrence ``kernels.ref.wkv6``, and 'auto' (every entry point's default)
the kernel on the card and 'scan' on the CPU, which is what ``repro`` runs
in its serving steps.

Inside the sharded steps (``sharding.spmd``) with the heads and d_ff over
"model" (``spmd.tp_keeps``) a rank runs its H / M time-mix heads (its
columns of wr / wk / wv / wg, rows of wo, its heads of u, gn_scale and
the state ``S``: the wkv scan, K5 on the card, on the rank's slab) and its
d_ff columns of the channel mix; the DDLerp and decay LoRAs and ``cr``
run whole. With the residual's rows over "model" (``spmd.sp_on``) the
time mix gathers every row first (the scan needs them all) and
reduce-scatters wo's partial sums back; the channel mix shifts in the
previous rank's last row (``spmd.halo``). Outside the step every helper
is the identity and the results do not move by a bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.sharding import spmd

LORA_R = 32
DECAY_R = 64
STATE_KEYS = ("S", "x_tm", "x_cm")


def _shift(x):
    """Token shift: x_{t-1} (zeros at t = 0). x: (B, T, D)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _shift_from(x, state, key):
    """Token shift whose t = 0 row is the carried ``state[key]`` (decode
    and prefill chunks), or zeros without a state."""
    if state is None or key not in state:
        return _shift(x)
    return torch.cat([state[key].to(x.dtype)[:, None], x[:, :-1]], dim=1)


def _shift_rows(x):
    """Token shift on the rank's rows of the sequence (``spmd.sp_on``, a
    stateless forward): row 0 is the previous "model" rank's last row,
    zeros on rank 0 (``spmd.halo``)."""
    return torch.cat([spmd.halo(x, 1), x[:, :-1]], dim=1)


def init(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    """Random weights drawn from ``gen`` on ``device``: ``repro``'s layout,
    scales and zero / constant leaves (the draws themselves differ)."""
    D, Fd, H, N = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim
    lead = (cfg.num_layers,)

    def dense(shape, fan_in):
        return L._dense(gen, lead + shape, fan_in, device)

    def const(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=device)

    layers = {
        "ln1": L.norm_init(D, lead, device, kind="layernorm"),
        "ln2": L.norm_init(D, lead, device, kind="layernorm"),
        "mu_x": const((D,), 0.0),
        "mu": const((5, D), 0.0),
        # repro scales a dense init by its first axis: 5 here
        "lora_A": dense((5, D, LORA_R), 5),
        "lora_B": const((5, LORA_R, D), 0.0),
        "w0": const((D,), -2.0),
        "wA": dense((D, DECAY_R), D),
        "wB": const((DECAY_R, D), 0.0),
        "u": const((H, N), 0.0),
        "wr": dense((D, D), D),
        "wk": dense((D, D), D),
        "wv": dense((D, D), D),
        "wg": dense((D, D), D),
        "wo": dense((D, D), D),
        "gn_scale": const((H, N), 1.0),
        "cmu_k": const((D,), 0.0),
        "cmu_r": const((D,), 0.0),
        "ck": dense((D, Fd), D),
        "cv": dense((Fd, D), Fd),
        "cr": dense((D, D), D),
    }
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, D, device),
        "layers": layers,
        "final_norm": L.norm_init(D, device=device, kind="layernorm"),
        "unembed": {"w": L._dense(gen, (D, cfg.padded_vocab), D, device)},
    }


# ------------------------------------------------------------ time mix
def _ddlerp(lp, x, xprev):
    """Data-dependent lerp producing (x_r, x_k, x_v, x_w, x_g), (5, B, T,
    D)."""
    xx = xprev - x
    base = x + xx * lp["mu_x"].to(x.dtype)
    lo = torch.einsum("btd,sdr->sbtr", torch.tanh(base),
                      lp["lora_A"].to(x.dtype))
    lo = torch.einsum("sbtr,srd->sbtd", lo, lp["lora_B"].to(x.dtype))
    mix = lp["mu"].to(x.dtype)[:, None, None, :] + lo
    return x[None] + xx[None] * mix


def _time_mix(lp, x, cfg: ArchConfig, state, impl: str = "scan"):
    """impl: 'scan' (``ref.wkv6``), 'pallas' (``ops.wkv6``) or 'auto'.

    Inside the sharded step with the heads over "model" (``spmd.tp_split``
    of wr) the rank runs its heads: r, k, v and g from its columns, the
    decay computed whole and cut to its heads (``spmd.tp_narrow``), the
    scan and the group norm on them, and wo's rows give a partial sum.
    Without the rows over "model" the DDLerp outputs enter the split
    products through ``spmd.tp_copy``, so the LoRAs' gradients are whole;
    under ``spmd.sp_on`` the rank's rows are gathered first and wo's sums
    reduce-scattered back."""
    sp = spmd.sp_on()
    if sp:
        x = spmd.sp_gather(x)
    B, T, D = x.shape
    N = cfg.head_dim
    wr = lp["wr"]           # read once: a read gathers it when sharded
    split = spmd.tp_split(wr) is not None
    H = wr.shape[-1] // N   # the rank's heads when split
    impl = L.resolve_scan_impl(impl, x, "scan")
    xprev = _shift_from(x, state, "x_tm")
    x_r, x_k, x_v, x_w, x_g = _ddlerp(lp, x, xprev).unbind(0)
    if split and not sp:
        x_r, x_k, x_v, x_g = (spmd.tp_copy(t) for t in (x_r, x_k, x_v, x_g))
    r = (x_r @ wr.to(x.dtype)).reshape(B, T, H, N)
    k = (x_k @ lp["wk"].to(x.dtype)).reshape(B, T, H, N)
    v = (x_v @ lp["wv"].to(x.dtype)).reshape(B, T, H, N)
    g = L.silu(x_g @ lp["wg"].to(x.dtype))
    dec = (lp["w0"].float()
           + torch.tanh(x_w.float() @ lp["wA"].float()) @ lp["wB"].float())
    w = torch.exp(-torch.exp(dec)).reshape(B, T, cfg.num_heads, N).to(x.dtype)
    if split:               # K5 reads a contiguous slab
        w = spmd.tp_narrow(w, 2, H).contiguous()

    S0 = (state["S"].float() if state is not None
          else torch.zeros((B, H, N, N), dtype=torch.float32,
                           device=x.device))
    if impl == "pallas":
        # the TPU kernel reads its inputs as f32 (a no-op at f32 compute);
        # u reaches it in x's dtype, as ``repro`` passes it
        y, S = kops.wkv6(r.float(), k.float(), v.float(), w.float(),
                         lp["u"].to(x.dtype).float(), S0)
    elif impl == "scan":
        y, S = ref.wkv6(r, k, v, w, lp["u"].float(), S0)
    else:
        raise ValueError(f"scan_impl must be 'auto', 'scan' or 'pallas', "
                         f"got {impl!r}")
    # per-head group norm, population variance as jnp.var
    mu = y.mean(-1, keepdim=True)
    yc = y - mu
    var = torch.mean(yc * yc, dim=-1, keepdim=True)
    y = yc * torch.rsqrt(var + 1e-5) * lp["gn_scale"].float()[None, None]
    y = y.reshape(B, T, H * N).to(x.dtype) * g
    out = y @ lp["wo"].to(x.dtype)
    if sp:
        out = spmd.sp_scatter(out) if split else spmd.sp_narrow(out)
    elif split:
        out = spmd.tp_sum(out)
    return out, {"S": S, "x_tm": x[:, -1].float()}


def _channel_mix(lp, x, state):
    """Inside the sharded step with d_ff over "model" (``spmd.tp_split`` of
    ck) the rank's columns of ck and rows of cv give a partial sum,
    reduced before the gate r (cr read whole; the rank's rows under
    ``spmd.sp_on``) multiplies it; only xk enters the split product
    (``spmd.tp_copy``, or the rows gathered under ``sp_on``)."""
    sp = spmd.sp_on()
    xx = (_shift_rows(x) if sp else _shift_from(x, state, "x_cm")) - x
    xk = x + xx * lp["cmu_k"].to(x.dtype)
    xr = x + xx * lp["cmu_r"].to(x.dtype)
    ck = lp["ck"]
    split = spmd.tp_split(ck) is not None
    if sp:
        xk = spmd.sp_gather(xk)
    elif split:
        xk = spmd.tp_copy(xk)
    k = torch.square(F.relu(xk @ ck.to(x.dtype)))
    kv = k @ lp["cv"].to(x.dtype)
    if sp:
        kv = spmd.sp_scatter(kv) if split else spmd.sp_narrow(kv)
    elif split:
        kv = spmd.tp_sum(kv)
    r = L.sigmoid(xr @ lp["cr"].to(x.dtype))
    return r * kv, {"x_cm": x[:, -1].float()}


def _layer_apply(cfg: ArchConfig, lp, x, state, impl):
    h = L.apply_norm(x, lp["ln1"], "layernorm")
    tm, st1 = _time_mix(lp, h, cfg, state, impl)
    x = x + tm
    h = L.apply_norm(x, lp["ln2"], "layernorm")
    cm, st2 = _channel_mix(lp, h, state)
    return x + cm, {**st1, **st2}


def _logits(params, cfg: ArchConfig, x):
    x = L.apply_norm(x, params["final_norm"], "layernorm")
    return L.lm_logits(params["embed"], x, params["unembed"]["w"],
                       vocab=cfg.vocab_size).float()


# ------------------------------------------------------------ public
def forward(params, cfg: ArchConfig, tokens, *, compute_dtype=torch.float32,
            attn_impl: str = "einsum", scan_impl: str = "auto",
            remat=False, return_features: bool = False):
    """tokens: (B, S) -> (logits (B, S, Vp) float32, aux), or (features
    after the final norm, aux) with ``return_features``. ``attn_impl`` is
    accepted for the common signature; rwkv has no attention. ``remat``
    checkpoints each layer (``layers.remat``); training runs the plain
    scan (``scan_impl="scan"``): K5 has no backward, as ``repro``'s has
    none."""
    del attn_impl
    x = L.embed_lookup(params["embed"], tokens, compute_dtype)
    body = L.remat(lambda lp, x: _layer_apply(cfg, lp, x, None, scan_impl)[0],
                   remat)
    for i in range(cfg.num_layers):
        x = body(L.layer_params(params["layers"], i), x)
    zero = torch.zeros((), device=x.device)
    aux = {"moe_aux": zero, "moe_z": zero}
    if return_features:
        return L.apply_norm(x, params["final_norm"], "layernorm"), aux
    return _logits(params, cfg, x), aux


def param_logical(cfg: ArchConfig) -> dict:
    """Logical axes of every leaf of ``init``'s params, as ``repro``'s."""
    layer = {
        "ln1": L.norm_logical("layernorm"), "ln2": L.norm_logical("layernorm"),
        "mu_x": (None,), "mu": (None, None),
        "lora_A": (None, "fsdp", None), "lora_B": (None, None, "fsdp"),
        "w0": (None,), "wA": ("fsdp", None), "wB": (None, "fsdp"),
        "u": ("heads", None),
        "wr": ("fsdp", "heads"), "wk": ("fsdp", "heads"),
        "wv": ("fsdp", "heads"), "wg": ("fsdp", "heads"),
        "wo": ("heads", "fsdp"), "gn_scale": ("heads", None),
        "cmu_k": (None,), "cmu_r": (None,),
        "ck": ("fsdp", "d_ff"), "cv": ("d_ff", "fsdp"), "cr": ("fsdp", None),
    }
    return {"embed": L.embed_logical(),
            "layers": L.stacked_logical(layer),
            "final_norm": L.norm_logical("layernorm"),
            "unembed": {"w": ("fsdp", "vocab")}}



def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.float32,
               device=None):
    """Decode state: the wkv state and the two token-shift carries per
    layer, fp32 whatever ``dtype`` is, O(1) in s_max; a scalar ``pos``."""
    H, N, D, Lr = cfg.num_heads, cfg.head_dim, cfg.d_model, cfg.num_layers
    f32 = dict(dtype=torch.float32, device=device)
    return {"S": torch.zeros((Lr, batch, H, N, N), **f32),
            "x_tm": torch.zeros((Lr, batch, D), **f32),
            "x_cm": torch.zeros((Lr, batch, D), **f32),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}



def cache_logical(cfg: ArchConfig) -> dict:
    return {"S": (None, "batch", "heads", None, None),
            "x_tm": (None, "batch", None), "x_cm": (None, "batch", None),
            "pos": ()}

def _run_layers(params, cfg: ArchConfig, x, cache, impl, pos=None):
    """Every layer over x, carrying each layer's state from the cache and
    writing the new state back in place; with a per-slot ``pos``, freed
    slots keep theirs bit for bit (rwkv has no KV cache to page, so this
    is the whole freed-slot story)."""
    for i in range(cfg.num_layers):
        st = {key: cache[key][i] for key in STATE_KEYS}
        x, new = _layer_apply(cfg, L.layer_params(params["layers"], i), x,
                              st, impl)
        if pos is not None:
            new = L.freeze_inactive_rows(pos, new, st)
        for key in STATE_KEYS:
            cache[key][i].copy_(new[key])
    return x


def prefill_chunk(params, cfg: ArchConfig, tokens, cache, *,
                  compute_dtype=torch.float32, attn_impl: str = "einsum",
                  first: bool = False, scan_impl: str = "auto"):
    """One prompt chunk at full width: every projection runs at chunk
    width, only the per-channel wkv recurrence is sequential (K5 on the
    card). Returns (last-position logits (B, 1, Vp) float32, cache with
    ``pos`` advanced by C); the state is written in place."""
    del attn_impl, first
    x = L.embed_lookup(params["embed"], tokens, compute_dtype)
    x = _run_layers(params, cfg, x, cache, scan_impl)
    cache["pos"] = cache["pos"] + tokens.shape[1]
    return _logits(params, cfg, x[:, -1:]), cache


def decode_step(params, cfg: ArchConfig, token, cache, *,
                compute_dtype=torch.float32, scan_impl: str = "auto"):
    """token: (B, 1). Returns (logits (B, 1, Vp) float32, cache with
    ``pos`` advanced by one); the state is written in place. ``pos`` is a
    scalar (lockstep) or a (B,) per-slot vector."""
    x = L.embed_lookup(params["embed"], token, compute_dtype)
    pos = cache["pos"]
    x = _run_layers(params, cfg, x, cache, scan_impl, pos)
    cache["pos"] = pos + 1
    return _logits(params, cfg, x), cache
