"""Serving example of the port: continuous-batched decode across a batch of
requests through ``repro_torch.launch.serve.Server``, comparing fp32
weights with int8-quantized ones (int8 per-channel post-training
quantization, dequantized on load) — the counterpart of
``examples/serve_lm.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch rwkv6-7b
      (``--device cpu`` off the card)
"""
import argparse
import time

import numpy as np

from repro_torch.launch.serve import ServeConfig, Server


def bench(sc: ServeConfig) -> float:
    """Fill every slot, tick until all drain; returns generated tok/s."""
    server = Server(sc)
    rng = np.random.default_rng(0)
    for _ in range(sc.batch_slots):
        server.add_request(rng.integers(0, server.cfg.vocab_size,
                                        sc.prompt_len), sc.gen_len)
    t0 = time.perf_counter()
    while not all(server.slot_free):
        server.step_all()
    server.engine._sync()
    dt = time.perf_counter() - t0
    return sc.batch_slots * sc.gen_len / dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = dict(arch=args.arch, reduced=True, batch_slots=4, s_max=64,
                requests=4, prompt_len=6, gen_len=args.gen_len,
                device=args.device)
    bench(ServeConfig(**dict(base, gen_len=2)))      # warm-up
    tps_fp32 = bench(ServeConfig(**base))
    tps_int8 = bench(ServeConfig(**base, quantize_int8=True))
    print(f"{args.arch}: fp32 {tps_fp32:.1f} tok/s | int8-weights "
          f"{tps_int8:.1f} tok/s ({args.device}, reduced config)")


if __name__ == "__main__":
    main()
