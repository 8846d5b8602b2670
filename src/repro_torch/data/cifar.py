"""CIFAR-10 *binary* format reader, the format the paper streams from the
ZCU104's SD card (§4.1). A copy of ``repro/data/cifar.py``: numpy only, and
the same arrays bit for bit.

Each record: 1 label byte + 3072 image bytes (3 x 32 x 32, channel-planar).
Files: data_batch_{1..5}.bin (train), test_batch.bin (10k test records).
"""
from __future__ import annotations

import pathlib
from typing import Tuple

import numpy as np

RECORD_BYTES = 1 + 3 * 32 * 32
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def read_binary(path) -> Tuple[np.ndarray, np.ndarray]:
    """-> images (N,32,32,3) float32 in [0,1]; labels (N,) int32."""
    raw = np.frombuffer(pathlib.Path(path).read_bytes(), np.uint8)
    if raw.size % RECORD_BYTES:
        raise ValueError(f"corrupt CIFAR binary: {path}")
    rec = raw.reshape(-1, RECORD_BYTES)
    labels = rec[:, 0].astype(np.int32)
    imgs = rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return imgs.astype(np.float32) / 255.0, labels


def write_binary(path, images: np.ndarray, labels: np.ndarray):
    """Inverse of read_binary: images (N,32,32,3) in [0,1] are clipped and
    truncated to bytes."""
    imgs = np.clip(images * 255.0, 0, 255).astype(np.uint8)
    imgs = imgs.transpose(0, 3, 1, 2).reshape(len(labels), -1)
    rec = np.concatenate([labels.astype(np.uint8)[:, None], imgs], axis=1)
    pathlib.Path(path).write_bytes(rec.tobytes())


def normalize(images: np.ndarray) -> np.ndarray:
    return (images - CIFAR10_MEAN) / CIFAR10_STD


def batches(images, labels, batch_size: int, *, seed: int = 0,
            train: bool = True):
    """Normalized (images, labels) batches: shuffled and endless when
    ``train``, one ordered pass otherwise (a short last batch is dropped)."""
    n = len(labels)
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.permutation(n) if train else np.arange(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = idx[i:i + batch_size]
            yield normalize(images[sel]), labels[sel]
        if not train:
            return
