"""Deterministic synthetic data pipelines (no network access): token
streams for LM training and a CIFAR-shaped image task for the paper's
ResNet20 experiments, as ``repro/data/synthetic.py``. The generators are
numpy's, seeded as the reference seeds them, so batch ``k`` of a stream
and the images of a seed are byte-equal in both packages.

The token pipeline is a real input pipeline: deterministic per-step RNG
(restart-safe: resuming at step k reproduces the same batch), a host-side
prefetch thread, and the batch moved to the trainer's device (each rank's
rows of it on a mesh).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from repro_torch.sharding import specs


class TokenStream:
    """Markov-chain token stream: next-token structure exists, so CE loss
    falling below log(vocab) demonstrates actual learning."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0,
                 branching: int = 32):
        self.vocab, self.batch, self.seq_len = vocab, batch, seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        # sparse transition table: each token can be followed by `branching`
        self.next_tokens = rng.integers(0, vocab, size=(vocab, branching),
                                        dtype=np.int32)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((self.batch, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        choices = rng.integers(0, self.next_tokens.shape[1],
                               size=(self.batch, self.seq_len))
        for t in range(self.seq_len):
            toks[:, t + 1] = self.next_tokens[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Host-side prefetch: overlaps batch generation with device compute;
    with ``device``, each batch's arrays become tensors there, and with
    ``sharding`` (a ``specs.NamedSharding`` per key) DTensors holding this
    rank's block of each."""

    def __init__(self, it: Iterator, depth: int = 2, device=None,
                 sharding=None):
        self.it = it
        self.device = device
        self.sharding = sharding
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        for item in self.it:
            if self._stop.is_set():
                return
            if self.sharding is not None:
                item = {k: specs.distribute(torch.from_numpy(
                    np.ascontiguousarray(v)), self.sharding[k], self.device)
                    for k, v in item.items()}
            elif self.device is not None:
                item = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device) for k, v in item.items()}
            self.q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass


def make_lm_pipeline(vocab: int, global_batch: int, seq_len: int, *,
                     seed: int = 0, start_step: int = 0, prefetch: int = 2,
                     device=None, mesh=None):
    """Batches ``start_step``, ``start_step + 1``, ... of a
    :class:`TokenStream`, prefetched onto ``device``. With ``mesh`` (a
    ``DeviceMesh``) each rank gets DTensors of its "batch" rows, the rows
    the reference's ``NamedSharding`` gives its shard (on the mesh's
    device type unless ``device`` says)."""
    sharding = None
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"make_lm_pipeline: mesh must be a DeviceMesh, "
                            f"not {type(mesh).__name__}")
        device = device or mesh.device_type
        with specs.use_mesh(mesh):
            rows = specs.sharding_for((global_batch, seq_len),
                                      ("batch", None))
        sharding = {"tokens": rows, "labels": rows}
    stream = TokenStream(vocab, global_batch, seq_len, seed)

    def gen():
        step = start_step
        while True:
            yield stream.batch_at(step)
            step += 1

    return Prefetcher(gen(), depth=prefetch, device=device,
                      sharding=sharding)


# ----------------------------------------------------------- CIFAR-like task


def synthetic_cifar(n: int, *, seed: int = 0, num_classes: int = 10,
                    image_size: int = 32, template_seed: int = 0):
    """Separable image classification task with CIFAR-10 geometry: each class
    is a smooth random template + noise. Returns images (n, size, size, 3)
    float32 and labels (n,) int32.

    Class templates come from `template_seed` (fixed across train/test splits);
    `seed` only draws the samples/noise."""
    rng_t = np.random.default_rng(template_seed)
    rng = np.random.default_rng(seed)
    base = rng_t.normal(0, 1, size=(num_classes, image_size, image_size, 3))
    # low-pass the templates so convs have spatial structure to find
    k = np.ones((5, 5)) / 25.0
    pad = np.pad(base, ((0, 0), (2, 2), (2, 2), (0, 0)), mode="edge")
    win = sliding_window_view(pad, (5, 5), axis=(1, 2))
    base = np.einsum("cijdkl,kl->cijd", win, k)
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    images = base[labels] + rng.normal(0, 0.6, size=(n, image_size, image_size, 3))
    return images.astype(np.float32), labels
