"""The trainer, as ``repro/launch/train.py``: data pipeline -> train
step -> checkpoint manager, with auto-resume and straggler detection.

Reduced configs train in fp32, the others in bf16 with every layer
checkpointed (remat), attention through the einsum, all as the reference
does. The trainer runs on ``--device`` (default ``cuda``) and never moves
to another device by itself.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --reduced --steps 100 --batch 8 --seq-len 128 --ckpt-dir /tmp/run1 \\
      [--device cpu]

On a mesh, one process per rank (``--mesh-shape D M``: data x model):

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --mesh-shape 2 2 ...
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import os
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import steps as steps_mod
from repro_torch.models.registry import Model, get_model, reduced_config
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import cosine, wsd
from repro_torch.runtime.fault import StragglerDetector
from repro_torch.sharding import specs

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    arch: str = "minicpm-2b"
    reduced: bool = True
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    warmup: int = 10
    schedule: str = "cosine"      # cosine | wsd | constant
    microbatches: int = 1
    checkpoint_every: int = 50
    ckpt_dir: str = ""
    seed: int = 0
    mesh_shape: tuple = ()        # () => single device
    log_every: int = 10
    device: str = "cuda"


def make_optimizer(tc: TrainConfig) -> AdamW:
    if tc.schedule == "wsd":   # minicpm's schedule (arXiv:2404.06395)
        lr = wsd(tc.lr, tc.warmup, int(tc.steps * 0.8) - tc.warmup,
                 max(tc.steps - int(tc.steps * 0.8), 1))
    else:
        lr = cosine(tc.lr, tc.warmup, tc.steps)
    return AdamW(learning_rate=lr)


def extras_for(model: Model, batch_np, dtype=torch.float32, device=None):
    """The frontend stubs a batch carries, as the reference's trainer makes
    them: a VLM's image embeddings and an encoder-decoder's 24 frames, all
    0.02."""
    cfg = model.cfg
    B = batch_np["tokens"].shape[0]
    out = {}
    if cfg.cross_attn_every:
        out["image_embeds"] = torch.ones(
            (B, cfg.num_image_tokens, cfg.d_model), dtype=dtype,
            device=device) * 0.02
    if cfg.encoder_layers:
        out["frames"] = torch.ones((B, 24, cfg.d_model), dtype=dtype,
                                   device=device) * 0.02
    return out


def _mesh_for(tc: TrainConfig, device: torch.device):
    """The ("data", "model") mesh of ``tc.mesh_shape`` over the process
    group (made from the environment under ``torchrun`` with PyTorch's
    default backend; never a fallback to one device), and this rank's
    device."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"train: mesh_shape {tuple(tc.mesh_shape)} needs a process "
                f"group: torch.distributed.init_process_group in each rank, "
                f"or torchrun --nproc-per-node N")
        dist.init_process_group()
    world, n = dist.get_world_size(), math.prod(tc.mesh_shape)
    if n != world:
        raise ValueError(f"train: mesh_shape {tuple(tc.mesh_shape)} has {n} "
                         f"ranks, the process group {world}")
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = make_mesh(tc.mesh_shape, ("data", "model")[:len(tc.mesh_shape)],
                     device.type)
    return mesh, device


def train(tc: TrainConfig) -> dict:
    """Train, on one device, or SPMD on ``tc.mesh_shape`` (every rank of the
    process group calls it alike; the state is placed by
    ``steps.state_shardings``, the batch by ``steps.batch_shardings``;
    rank 0 logs and writes the checkpoints)."""
    device = torch.device(tc.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: --device cuda but CUDA is not available "
                           "(pass --device cpu to train on the CPU)")
    mesh = None
    if tc.mesh_shape:
        mesh, device = _mesh_for(tc, device)
    lead = mesh is None or not any(mesh.get_coordinate())
    cfg = configs.get_config(tc.arch)
    if tc.reduced:
        cfg = reduced_config(cfg)
    model = get_model(cfg)
    optimizer = make_optimizer(tc)

    mgr = CheckpointManager(tc.ckpt_dir) if tc.ckpt_dir else None
    detector = StragglerDetector()
    stream = TokenStream(cfg.vocab_size, tc.batch, tc.seq_len, tc.seed)

    step_fn = steps_mod.make_train_step(
        model, optimizer,
        compute_dtype=torch.float32 if tc.reduced else torch.bfloat16,
        attn_impl="einsum", remat=not tc.reduced,
        microbatches=tc.microbatches)

    with specs.use_mesh(mesh):
        start = 0
        state = None
        # without a mesh every sharding is None and placing is a move
        if mgr is not None and mgr.latest_step() is not None:
            state, meta = mgr.restore(shardings=steps_mod.state_shardings(
                model, steps_mod.train_state_shapes(model, optimizer)),
                device=device)
            start = meta["step"]
            if lead:
                log.info("resumed from step %d", start)
        if state is None:
            gen = torch.Generator(device).manual_seed(tc.seed)
            state = steps_mod.init_train_state(model, optimizer, gen, device)
            state = steps_mod.place(state, steps_mod.state_shardings(
                model, state))

        losses = []
        for step in range(start, tc.steps):
            t0 = time.time()
            raw = stream.batch_at(step)
            batch = {k: torch.from_numpy(v.copy()).to(device)
                     for k, v in raw.items()}
            batch.update(extras_for(model, raw, device=device))
            batch = steps_mod.place(batch, steps_mod.batch_shardings(
                model, batch))
            state, metrics = step_fn(state, batch)
            if (step + 1) % tc.log_every == 0 or step == start:
                loss = float(metrics["loss"])
                losses.append(loss)
                if lead:
                    log.info("step %d loss %.4f (%.2fs)", step + 1, loss,
                             time.time() - t0)
            detector.record(time.time() - t0)
            if mgr is not None and (step + 1) % tc.checkpoint_every == 0:
                mgr.save(step + 1, state)
        if mgr is not None:
            mgr.save(tc.steps, state, block=True)
    final_loss = float(metrics["loss"])
    return {"final_loss": final_loss, "losses": losses,
            "stragglers": len(detector.flagged)}


def main():
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainConfig):
        name = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            ap.add_argument(name, action="store_true", default=f.default)
        elif isinstance(f.default, tuple):
            ap.add_argument(name, type=int, nargs="*", default=list(f.default))
        else:
            ap.add_argument(name, type=type(f.default), default=f.default)
    args = ap.parse_args()
    tc = TrainConfig(**{f.name: tuple(v) if isinstance(v, list) else v
                        for f, v in ((f, getattr(args, f.name))
                                     for f in dataclasses.fields(TrainConfig))})
    stats = train(tc)
    print(f"final_loss={stats['final_loss']:.4f}")


if __name__ == "__main__":
    main()
