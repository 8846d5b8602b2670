"""Post-training quantization walkthrough on the port, the counterpart of
``examples/quantize_ptq.py``: per-channel int8 and fixed-16 on an LM,
with a per-layer error report and a quantized-vs-float logits comparison
(the paper's quantization methodology applied to the LM zoo).

Run:  PYTHONPATH=src python -m repro_torch.examples.quantize_ptq \\
          --arch minicpm-2b [--device cpu]
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.core.quantize import (dequantize_params, fixed_point_tree,
                                       quantization_error, quantize_params,
                                       quantized_bytes)
from repro_torch.models.registry import get_model, reduced_config
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = reduced_config(configs.get_config(args.arch))
    model = get_model(cfg)
    gen = torch.Generator(device).manual_seed(0)
    params = model.init(gen, device)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                         device=device)
    extras = model.extra_inputs(2, torch.float32, device)

    with torch.no_grad():
        ref_logits, _ = model.forward(params, toks,
                                      compute_dtype=torch.float32, **extras)

        qp = quantize_params(params)
        fp_bytes = sum(t.numel() * t.element_size() for t in
                       tree_leaves(params))
        print(f"{args.arch}: fp32 {fp_bytes/1e6:.1f} MB -> int8 "
              f"{quantized_bytes(qp)/1e6:.1f} MB "
              f"({fp_bytes/quantized_bytes(qp):.2f}x smaller)")

        errs = quantization_error(params, qp)
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
        print("worst per-layer relative L2 error:")
        for name, e in worst:
            print(f"  {e:.5f}  {name}")

        real = slice(0, cfg.vocab_size)
        for name, tree in [("int8", dequantize_params(qp, torch.float32)),
                           ("fixed16", fixed_point_tree(params))]:
            logits, _ = model.forward(tree, toks, compute_dtype=torch.float32,
                                      **extras)
            top1 = float(torch.mean((logits[..., real].argmax(-1)
                                     == ref_logits[..., real].argmax(-1))
                                    .float()))
            err = float((logits[..., real] - ref_logits[..., real]).abs()
                        .max())
            print(f"{name}: top-1 agreement {top1:.3f}, max |dlogit| "
                  f"{err:.4f}")


if __name__ == "__main__":
    main()
