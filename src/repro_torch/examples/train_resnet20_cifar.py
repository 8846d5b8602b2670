"""The paper's end-to-end experiment on the port, the counterpart of
``examples/train_resnet20_cifar.py``: train ResNet20 with AdamW on the
synthetic CIFAR task, fold BN, quantize to the paper's 16-bit fixed point
and to int8, measure the accuracy drop, time inference on the device it
ran on, and print the four-strategy FPS ladder of the calibrated
performance model: the model's predictions for the ZCU104 FPGA, not
measurements.

With ``--conv-impl im2col`` (the default) every convolution is an im2col
GEMM through ``kernels.ops.matmul``: on the card the systolic GEMM
kernel (K7) carries its forward and both gradient GEMMs; on the CPU the
plain version does. ``--conv-impl lax`` convolves with ``F.conv2d``, the
reference example's own route.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_resnet20_cifar \\
          [--steps 300] [--device cpu] [--conv-impl lax]
"""
import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch.configs.resnet20_cifar import CONFIG as FULL_CFG
from repro_torch.configs.resnet20_cifar import ResNetConfig
from repro_torch.core import perfmodel as pm
from repro_torch.core.dataflow import Gemm
from repro_torch.core.quantize import (dequantize_params, fixed_point_tree,
                                       quantize_params)
from repro_torch.data.synthetic import synthetic_cifar
from repro_torch.kernels import ops
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import resnet
from repro_torch.models.resnet import conv_layer_shapes
from repro_torch.optim.adamw import AdamW, apply_updates


def conv_route(conv_impl: str) -> dict:
    """``resnet.forward``'s keywords for a route: im2col GEMMs through
    ``ops.matmul``, or ``F.conv2d``."""
    if conv_impl == "im2col":
        return dict(impl="im2col", matmul_fn=ops.matmul)
    return dict(impl="lax")


def loss_fn(cfg, route):
    """Mean cross entropy of the logits against one-hot labels, written as
    the reference writes it."""
    def run(params, batch):
        logits = resnet.forward(params, cfg, batch["x"], **route)
        onehot = F.one_hot(batch["y"].long(), cfg.num_classes).float()
        return -torch.mean(torch.sum(onehot * F.log_softmax(logits, -1),
                                     -1)), {}
    return run


def accuracy(cfg, params, xs, ys, route, folded=False):
    with torch.no_grad():
        logits = resnet.forward(params, cfg, xs, folded=folded, **route)
    return float(torch.mean((logits.argmax(-1) == ys).float()))


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type.upper()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--width", type=int, default=None,
                    help="base width (paper: 16, the default on the card; "
                         "8 on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--conv-impl", choices=("im2col", "lax"),
                    default="im2col")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda but CUDA is not available "
                             "(pass --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    width = args.width or (16 if device.type == "cuda" else 8)
    route = conv_route(args.conv_impl)

    cfg = ResNetConfig(widths=(width, width * 2, width * 4))
    params = resnet.init(cfg, torch.Generator(device).manual_seed(0), device)
    opt = AdamW(learning_rate=3e-3, weight_decay=1e-4)
    opt_state = opt.init(params)
    xs, ys = (torch.from_numpy(a).to(device)
              for a in synthetic_cifar(4096, seed=1))
    xt, yt = (torch.from_numpy(a).to(device)
              for a in synthetic_cifar(1024, seed=2))
    grad_fn = value_and_grad(loss_fn(cfg, route))

    bs = 128
    t0 = time.time()
    for i in range(args.steps):
        j = (i * bs) % (len(ys) - bs)
        (loss, _), grads = grad_fn(params, {"x": xs[j:j + bs],
                                            "y": ys[j:j + bs]})
        updates, opt_state, _ = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        if (i + 1) % 50 == 0:
            print(f"step {i+1}: loss {float(loss):.4f}")
    if not torch.isfinite(loss):
        raise SystemExit(f"non-finite loss {float(loss)}")
    print(f"trained {args.steps} steps in {time.time()-t0:.1f}s "
          f"(width {width}, {args.conv_impl}, {device_label(device)})")

    # ---- quantization accuracy (the paper's 92% -> 90% experiment) ----
    folded = resnet.fold_bn(params)
    acc32 = accuracy(cfg, folded, xt, yt, route, folded=True)
    acc16 = accuracy(cfg, fixed_point_tree(folded), xt, yt, route,
                     folded=True)
    acc8 = accuracy(cfg, dequantize_params(quantize_params(folded),
                                           torch.float32),
                    xt, yt, route, folded=True)
    print(f"\naccuracy: fp32 {acc32:.3f} | fixed16 {acc16:.3f} "
          f"(drop {acc32-acc16:+.3f}) | int8 {acc8:.3f} (drop {acc32-acc8:+.3f})")
    print("paper:    fp32 0.92  | fixed16 0.90  (drop +0.020)")

    # ---- measured inference on this device (batch 64) ----
    xb = xt[:64]
    with torch.no_grad():
        def infer():
            return resnet.forward(folded, cfg, xb, folded=True, **route)
        infer()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        for _ in range(20):
            infer()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fps = 64 * 20 / (time.time() - t0)
    print(f"\nmeasured inference on {device_label(device)}: {fps:.0f} FPS "
          f"(batch 64, {args.conv_impl}, width {width})")

    # ---- the paper's FPS ladder through the calibrated perf model ----
    gemms = [Gemm(n, m, k, nn, in_elems=m * k // 9 if k % 9 == 0 else m * k,
                  out_elems=m * nn)
             for (n, m, k, nn) in conv_layer_shapes(FULL_CFG, batch=1)]
    fit = pm.calibrate(gemms)
    rungs = pm.ladder(gemms, fit=fit)
    print("\nZCU104 ladder: the calibrated performance model's predictions "
          "for the FPGA, against the paper's Fig. 6 (not measured here):")
    print(f"  {'strategy':24s} {'model FPS':>10s} {'paper FPS':>10s} {'err':>7s}")
    for r in rungs:
        tgt = pm.PAPER_FPS[r.strategy]
        print(f"  {r.strategy:24s} {r.fps:10.2f} {tgt:10.2f} "
              f"{100*(r.fps-tgt)/tgt:+6.1f}%")
    print(f"\npaper GOP/s 21.12 @ 5.21 W; model final rung "
          f"{rungs[-1].gops:.2f} GOP/s")


if __name__ == "__main__":
    main()
