"""Quickstart on the port, the counterpart of ``examples/quickstart.py``:

1. Pick an assigned architecture, shrink it to a small scale.
2. Train a few steps on the synthetic pipeline.
3. Plan a layer with the paper's capacity planner (all four strategies;
   the reference's TPU profile, as the reference example plans).
4. Serve a few tokens through the decode path.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch import configs
from repro_torch.configs.base import MemoryStrategy
from repro_torch.core.dataflow import Gemm
from repro_torch.core.planner import plan_gemm
from repro_torch.core.strategies import TPU_V5E, planner_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import steps as steps_mod
from repro_torch.models.registry import get_model, reduced_config
from repro_torch.optim.adamw import AdamW


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    # ---- 1. model -----------------------------------------------------
    cfg = reduced_config(configs.get_config("qwen2.5-32b"))
    model = get_model(cfg)
    print(f"arch={cfg.name}  (reduced: {cfg.num_layers}L d={cfg.d_model})")

    # ---- 2. train -----------------------------------------------------
    opt = AdamW(learning_rate=1e-3)
    state = steps_mod.init_train_state(
        model, opt, torch.Generator(device).manual_seed(0), device)
    step = steps_mod.make_train_step(model, opt, compute_dtype=torch.float32,
                                     remat=False)
    stream = TokenStream(cfg.vocab_size, batch=4, seq_len=64, seed=0)
    for i in range(10):
        batch = {k: torch.from_numpy(v.copy()).to(device)
                 for k, v in stream.batch_at(i).items()}
        state, metrics = step(state, batch)
    print(f"train: 10 steps, loss {float(metrics['loss']):.3f}")

    # ---- 3. the paper's planner --------------------------------------
    g = Gemm("ffn_up", m=4096, k=5120, n=27648)   # one qwen2.5-32b FFN GEMM
    for strat in MemoryStrategy:
        plan = plan_gemm(g, planner_config(strat, TPU_V5E))
        print(f"plan[{strat.value:22s}] tiles={plan.tiling.bm}x{plan.tiling.bk}"
              f"x{plan.tiling.bn} stages={plan.stages} parts={plan.partitions} "
              f"reload={plan.reload:.2f} AI={plan.arithmetic_intensity:.0f} flop/B")

    # ---- 4. serve -----------------------------------------------------
    decode = steps_mod.make_decode_step(model, compute_dtype=torch.float32)
    cache = model.init_cache(2, 32, torch.float32, device=device)
    tok = torch.tensor([[1], [2]], dtype=torch.int32, device=device)
    out = []
    with torch.no_grad():
        for _ in range(8):
            logits, cache = decode(state["params"], cache, {"token": tok})
            tok = torch.argmax(logits[:, :, :cfg.vocab_size], -1).to(
                torch.int32)
            out.append(int(tok[0, 0]))
    print("decode:", out)
    print("quickstart OK")


if __name__ == "__main__":
    main()
