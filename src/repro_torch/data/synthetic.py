"""A CIFAR-shaped synthetic image task for the paper's ResNet20
experiments without the real dataset (no network access). A copy of
``repro.data.synthetic.synthetic_cifar``: numpy only, the same arrays bit
for bit from the same seeds."""
from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


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
