#!/usr/bin/env python3
"""How the rwkv6 stack grows the rounding of its wkv recurrence, on the CPU.

    python3 rwkv_rounding.py [--layers 2 4 8] [--seed 0] [--tokens 64]
        [--d-model 64 --heads 4 --head-dim 16 --d-ff 128] [--grads]

The reduced rwkv6-7b (``reduced_config``, at the widths given: by default
its own, d_model 64 and 4 heads of 16) with the most layers asked for, of
random weights, its constant leaves perturbed as ``chip_smoke.py``
perturbs them (``RECURRENT_NOISE``), runs its forward on (2, tokens)
seeded tokens through the plain fp32 recurrence ``ref.wkv6`` and through
two others, everything else unchanged:

- ``float64``: the same recurrence in float64, rounded to fp32 once per
  output (the exact answer, as far as fp32 can hold it);
- ``kernel order``: fp32 with the sum over i taken as the Hopper kernel
  (``csrc/linear_scan.cu``) takes it: 16 chains (8 row groups of two
  chains each, chain c over the group's rows c, c + 2, ... in order, one
  rounding per fused multiply-add), chain 0 + chain 1, groups added in
  order.

For each depth it prints, as a share of the largest fp32 logit, the
largest logit difference of each pair. If the stack amplifies every
rounding alike, the three differences grow at the same rate with depth,
and the kernel's order is no further from float64 than the reference's.
With ``--grads`` it also prints, for the step-1 gradients of the training
loss (``launch.steps.make_loss_fn``, the plain recurrence), each as the
largest share of a leaf's largest float64 gradient, beside that leaf:
how far the fp32 gradients sit from float64's (``launch.witness``), and
how far the float64 gradients move when every weight is multiplied by
1 + 2^-24 N(0, 1), about what rounding it to fp32 does. The second is the
gradients' conditioning: two fp32 computations of them whose sums run in
other orders (a step split over ranks against one that is not) can be
that far apart with neither wrong. Exits 0; it checks nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.registry import get_model, reduced_config  # noqa: E402

RWKV = "rwkv6-7b"
# chip_smoke.RECURRENT_NOISE[RWKV]: repro's init leaves these constant
NOISE = {"u": 0.1, "mu": 0.1, "mu_x": 0.1, "lora_B": 0.01, "wB": 0.01}
GROUPS, CHAINS = 8, 2


def wkv6_float64(r, k, v, w, u, s0):
    """``ref.wkv6``'s recurrence in float64, rounded to fp32 at the end."""
    r, k, v, w, u, S = (t.double() for t in (r, k, v, w, u, s0))
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               S + u[None, :, :, None] * kv))
        S = w[:, t][..., None] * S + kv
    return torch.stack(ys, 1).float(), S.float()


def wkv6_kernel_order(r, k, v, w, u, s0):
    """fp32, each element in the reference's order, the sum over i in the
    kernel's 16 chains. A fused multiply-add is emulated in float64 (the
    product of two fp32 values is exact there) and rounded to fp32."""
    r, k, v, w, u, S = (t.float() for t in (r, k, v, w, u, s0))
    B, T, H, N = r.shape
    R = max(N // GROUPS, CHAINS)
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # (B,H,N,N)
        term = S + u[None, :, :, None] * kv
        prod = r[:, t, :, :, None].double() * term.double()       # exact
        parts = []
        for g in range(0, N, R):
            chains = []
            for c in range(CHAINS):
                acc = torch.zeros((B, H, N), dtype=torch.float32)
                for i in range(g + c, min(g + R, N), CHAINS):
                    acc = (acc.double() + prod[:, :, i]).float()
                chains.append(acc)
            parts.append(chains[0] + chains[1])
        y = parts[0]
        for p in parts[1:]:
            y = y + p
        ys.append(y)
        S = w[:, t][..., None] * S + kv
    return torch.stack(ys, 1), S


def logits(model, params, toks, wkv):
    ssm.ref = _Ref(wkv)
    try:
        lg, _ = model.forward(params, toks, scan_impl="scan")
    finally:
        ssm.ref = ref
    return lg[..., :model.cfg.vocab_size].double()


def grad_conditioning(model, params, toks):
    """The step-1 gradients of the training loss
    (``launch.steps.make_loss_fn``, the plain recurrence): ((how far the
    fp32 gradients sit from float64's, the leaf), (how far the float64
    gradients move when every weight is multiplied by 1 + 2^-24 N(0, 1),
    the leaf)), each the largest over the leaves as a share of the leaf's
    largest float64 gradient."""
    from repro_torch.launch import steps, witness
    from repro_torch.tree import tree_map
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    def named(tree, prefix=""):
        if isinstance(tree, dict):
            return [kv for k in sorted(tree)
                    for kv in named(tree[k], f"{prefix}{k}/")]
        return [(prefix[:-1], tree)]

    def grads(p, dtype):
        loss_fn = steps.make_loss_fn(model, compute_dtype=dtype, remat=False)
        return named(steps.value_and_grad(loss_fn)(p, batch)[1])

    def worst(got, want):
        return max(((a.double() - b).abs().max().item()
                    / max(b.abs().max().item(), 1e-300), name)
                   for (name, a), (_, b) in zip(got, want))
    g32 = grads(params, torch.float32)
    gen = torch.Generator().manual_seed(5)
    with witness.float64():
        p64 = witness.to_float64(params)
        g64 = grads(p64, torch.float64)
        moved = grads(tree_map(lambda w: w * (1 + 2.0 ** -24 * torch.randn(
            w.shape, generator=gen, dtype=torch.float64)), p64),
            torch.float64)
    return worst(g32, g64), worst(moved, g64)


class _Ref:
    """``ref`` with its wkv6 replaced."""

    def __init__(self, wkv):
        self.wkv6 = wkv

    def __getattr__(self, name):
        return getattr(ref, name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=16)
    ap.add_argument("--d-ff", type=int, default=128)
    ap.add_argument("--grads", action="store_true")
    args = ap.parse_args()
    cfg = reduced_config(configs.get_config(RWKV),
                         num_layers=max(args.layers), d_model=args.d_model,
                         num_heads=args.heads, head_dim=args.head_dim,
                         d_ff=args.d_ff)
    model = get_model(cfg)
    gen = torch.Generator().manual_seed(args.seed)
    params = model.init(gen, "cpu")
    for key, scale in NOISE.items():
        leaf = params["layers"][key]
        leaf.add_(scale * torch.randn(leaf.shape, generator=gen))
    rng = np.random.default_rng(args.seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (2, args.tokens)))
    rows = []
    for layers in args.layers:
        cut = dataclasses.replace(model, cfg=dataclasses.replace(
            cfg, num_layers=layers))
        f32 = logits(cut, params, toks, ref.wkv6)
        f64 = logits(cut, params, toks, wkv6_float64)
        order = logits(cut, params, toks, wkv6_kernel_order)
        scale = f32.abs().max().item()
        row = {"layers": layers, "d_model": cfg.d_model,
               "heads": cfg.num_heads, "head_dim": cfg.head_dim,
               "tokens": args.tokens, "largest_logit": scale,
               "fp32_vs_float64": (f32 - f64).abs().max().item() / scale,
               "kernel_order_vs_float64":
                   (order - f64).abs().max().item() / scale,
               "kernel_order_vs_fp32":
                   (order - f32).abs().max().item() / scale}
        if args.grads:
            ((row["grads_fp32_vs_float64"], row["grads_fp32_leaf"]),
             (row["grads_moved_by_rounding"], row["grads_moved_leaf"])) = \
                grad_conditioning(cut, params, toks)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
