"""ResNet20 / CIFAR-10, the paper's evaluation model (Tensil
ResNet20-ZCU104), the counterpart of ``repro/models/resnet.py``.

Activations are NHWC and conv weights HWIO, as in the reference. A
convolution runs one of two ways, mirroring how the Tensil systolic array
executes it:
  * ``impl="lax"``    -- ``F.conv2d`` on permuted views (the oracle path, as
    ``lax.conv`` is in the reference; on the card it needs
    ``torch.backends.cudnn.allow_tf32 = False`` to stay fp32);
  * ``impl="im2col"`` -- explicit im2col + one GEMM per convolution, the
    lowering a systolic array performs; ``matmul_fn`` routes that GEMM,
    e.g. through the systolic kernel ``kernels.ops.matmul``.

BatchNorm is folded at inference (:func:`fold_bn`) as Tensil's compiler
does. Params are nested dicts with ``params["stages"]`` a list (stages) of
lists (blocks) of dicts, the reference's layout.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.resnet20_cifar import ResNetConfig


# ------------------------------------------------------------------ init
def _conv_init(gen, k, cin, cout, device):
    w = torch.randn((k, k, cin, cout), generator=gen, device=device)
    return w * math.sqrt(2.0 / (k * k * cin))


def _bn_init(c, device):
    return {"scale": torch.ones(c, device=device),
            "bias": torch.zeros(c, device=device),
            "mean": torch.zeros(c, device=device),
            "var": torch.ones(c, device=device)}


def init(cfg: ResNetConfig, gen: torch.Generator, device="cuda") -> dict:
    """He-initialised convs, identity BN, a small head; ``gen`` lives on
    ``device``."""
    def conv_bn(k, cin, cout):
        return {"w": _conv_init(gen, k, cin, cout, device),
                "bn": _bn_init(cout, device)}

    params = {"stem": conv_bn(3, cfg.in_channels, cfg.widths[0])}
    cin = cfg.widths[0]
    stages = []
    for si, (n, cout) in enumerate(zip(cfg.num_blocks, cfg.widths)):
        blocks = []
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = {"conv1": conv_bn(3, cin, cout),
                   "conv2": conv_bn(3, cout, cout)}
            if stride != 1 or cin != cout:
                blk["proj"] = conv_bn(1, cin, cout)
            blocks.append(blk)
            cin = cout
        stages.append(blocks)
    params["stages"] = stages
    params["head"] = {
        "w": torch.randn((cin, cfg.num_classes), generator=gen,
                         device=device) * 0.01,
        "b": torch.zeros(cfg.num_classes, device=device)}
    return params


# ------------------------------------------------------------------ conv paths
def _im2col(x, k, stride, pad):
    """x: (B,H,W,C) -> patches (B, Ho, Wo, k*k*C), the k*k shifted strided
    views concatenated in (di, dj, c) order: the row order of
    ``w.reshape(-1, Cout)`` for an HWIO weight."""
    B, H, W, C = x.shape
    x = F.pad(x, (0, 0, pad, pad, pad, pad))
    Ho = (H + 2 * pad - k) // stride + 1
    Wo = (W + 2 * pad - k) // stride + 1
    cols = [x[:, di:di + (Ho - 1) * stride + 1:stride,
              dj:dj + (Wo - 1) * stride + 1:stride, :]
            for di in range(k) for dj in range(k)]
    return torch.cat(cols, dim=-1)


def conv2d(x, w, stride=1, impl="lax", matmul_fn=None):
    """x: (B,H,W,Cin), w: (k,k,Cin,Cout), SAME padding."""
    k = w.shape[0]
    pad = (k - 1) // 2
    if impl == "lax":
        return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                        stride=stride, padding=pad).permute(0, 2, 3, 1)
    patches = _im2col(x, k, stride, pad)                   # (B,Ho,Wo,k*k*Cin)
    B, Ho, Wo, P = patches.shape
    wm = w.reshape(-1, w.shape[-1])                        # (k*k*Cin, Cout)
    lhs = patches.reshape(B * Ho * Wo, P)
    out = matmul_fn(lhs, wm) if matmul_fn is not None else lhs @ wm
    return out.reshape(B, Ho, Wo, w.shape[-1])


def _bn(x, p, eps=1e-5):
    inv = torch.rsqrt(p["var"] + eps) * p["scale"]
    return x * inv + (p["bias"] - p["mean"] * inv)


def fold_bn(params):
    """Fold BN into conv weights (Tensil-compiler style) for inference:
    each conv becomes {"w", "b"}."""
    def fold(conv):
        p = conv["bn"]
        inv = torch.rsqrt(p["var"] + 1e-5) * p["scale"]
        return {"w": conv["w"] * inv[None, None, None, :],
                "b": p["bias"] - p["mean"] * inv}
    out = {"stem": fold(params["stem"]), "head": params["head"], "stages": []}
    for blocks in params["stages"]:
        nb = []
        for blk in blocks:
            f = {"conv1": fold(blk["conv1"]), "conv2": fold(blk["conv2"])}
            if "proj" in blk:
                f["proj"] = fold(blk["proj"])
            nb.append(f)
        out["stages"].append(nb)
    return out


# ------------------------------------------------------------------ forward
def forward(params, cfg: ResNetConfig, images, *, folded=False, impl="lax",
            matmul_fn=None, compute_dtype=torch.float32):
    """images: (B, H, W, C) -> logits (B, num_classes)."""
    def apply_cb(cb, x, stride):
        y = conv2d(x, cb["w"].to(compute_dtype), stride, impl, matmul_fn)
        if folded:
            return y + cb["b"].to(compute_dtype)
        return _bn(y, {k: t.to(compute_dtype) for k, t in cb["bn"].items()})

    x = torch.relu(apply_cb(params["stem"], images.to(compute_dtype), 1))
    for si, blocks in enumerate(params["stages"]):
        for bi, blk in enumerate(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1   # derived, not a param
            h = torch.relu(apply_cb(blk["conv1"], x, stride))
            h = apply_cb(blk["conv2"], h, 1)
            sc = apply_cb(blk["proj"], x, stride) if "proj" in blk else x
            x = torch.relu(h + sc)
    x = x.mean(dim=(1, 2))
    return (x @ params["head"]["w"].to(compute_dtype)
            + params["head"]["b"].to(compute_dtype))


def conv_layer_shapes(cfg: ResNetConfig, batch: int = 1):
    """(name, M, K, N) im2col GEMM dims per conv, in forward order: the
    capacity planner's per-layer table and the kernel's main-path shapes."""
    shapes = []
    hw = cfg.image_size
    shapes.append(("stem", batch * hw * hw, 3 * 3 * cfg.in_channels,
                   cfg.widths[0]))
    cin = cfg.widths[0]
    for si, (n, cout) in enumerate(zip(cfg.num_blocks, cfg.widths)):
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            hw_out = hw // stride
            shapes.append((f"s{si}b{bi}c1", batch * hw_out * hw_out,
                           3 * 3 * cin, cout))
            shapes.append((f"s{si}b{bi}c2", batch * hw_out * hw_out,
                           3 * 3 * cout, cout))
            if stride != 1 or cin != cout:
                shapes.append((f"s{si}b{bi}proj", batch * hw_out * hw_out,
                               cin, cout))
            cin, hw = cout, hw_out
    return shapes
