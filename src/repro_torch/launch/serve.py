"""Serving CLI of the port — the counterpart of ``python -m
repro.launch.serve``. Serves synthetic greedy requests through
``repro_torch.serve.ServeEngine`` on the card (``--device cpu`` to run on
the CPU) and prints tok/s, TTFT p50 and latency p95:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-32b \\
      --no-reduced --num-layers 4 --s-max 1024 --requests 8

The default arch is hymba-1.5b (reduced), as the reference CLI's is;
``--arch rwkv6-7b`` serves the attention-free family (a page size is
ignored there, its state being O(1)).

``--num-layers`` cuts the depth of the arch (its widths stay), which is
how a full-width arch fits one card. As in ``ServeConfig``, the cache is
dense unless ``--page-size`` is given; ``--kv-backend`` picks its
representation by the reference's names (``paged_int8``: int8 pages;
``paged_latent``: MLA latent pages, with an MLA arch such as
``qwen2.5-32b-mla``); ``--prefill-mode`` and
``--prefill-attn-impl`` choose the prefill path (``auto``: the
flash-attention kernel on the card); ``--quantize-int8`` serves the
weights after int8 per-channel post-training quantization (quantized, then
dequantized to the compute dtype, as the reference CLI does).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import BACKENDS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the arch to this many layers (0 = keep)")
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=None,
                    help="page the cache (default: dense)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="0 = slots x s_max / page_size")
    ap.add_argument("--kv-backend", default=None, choices=sorted(BACKENDS),
                    help="cache representation (default: follows "
                         "--page-size)")
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--prefill-mode", default="parallel",
                    choices=("parallel", "scan"))
    ap.add_argument("--prefill-attn-impl", default="auto",
                    help="auto | pallas (the flash kernel) | einsum")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize-int8", action="store_true",
                    help="int8 per-channel PTQ of the weights")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true", help="print full metrics")
    args = ap.parse_args(argv)

    engine = ServeEngine.build(args.arch, config=ServeConfig(
        reduced=args.reduced,
        cfg_overrides=({"num_layers": args.num_layers} if args.num_layers
                       else None),
        batch_slots=args.batch_slots, s_max=args.s_max, seed=args.seed,
        quantize_int8=args.quantize_int8,
        page_size=args.page_size, num_pages=args.num_pages or None,
        kv_backend=args.kv_backend,
        prefix_cache=None if args.prefix_cache else False,
        prefill_chunk_tokens=args.prefill_chunk,
        prefill_mode=args.prefill_mode,
        prefill_attn_impl=args.prefill_attn_impl, device=args.device))
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        engine.submit(rng.integers(0, engine.cfg.vocab_size, args.prompt_len),
                      args.gen_len)
    m = engine.run()
    if args.json:
        print(json.dumps(m, indent=2, default=float))
    print(f"served {m['requests']} requests on {engine.device}, "
          f"{m['throughput_tokens_per_s']:.1f} tok/s | "
          f"ttft p50 {m['ttft_s']['p50'] * 1e3:.1f} ms | "
          f"latency p95 {m['latency_s']['p95'] * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
