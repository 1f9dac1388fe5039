"""Synthetic datasets (fake-data path).

A copy of ``tosem_tpu/data/synthetic.py`` (the port imports nothing of
the JAX package): pure numpy from seeded generators, so both packages
draw the same arrays bit for bit.

EfficientDet ships a ``--use_fake_data`` flag (``main.py:86``) so training
runs input-free in CI; DeepSpeech's CI trains on the single-sample LDC93S1
set. Same idea here: deterministic synthetic batches shaped like CIFAR-10
(32x32x3, 10 classes) and like MLM token streams, generated on host with a
seeded numpy RNG — zero downloads, zero egress, reproducible.

The labels are a deterministic function of the inputs (not pure noise) so a
training loop has signal to descend on: tests assert the loss actually
drops, which pure-noise labels would not allow.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class SyntheticImageDataset:
    n: int = 512
    hw: int = 32
    classes: int = 10
    seed: int = 0

    def _teacher(self) -> np.ndarray:
        """The fixed linear teacher, drawn from its own RNG stream so
        train and val label-generation can never desynchronize."""
        rng = np.random.default_rng(self.seed + 7777)
        return rng.standard_normal((self.hw * self.hw * 3, self.classes),
                                   dtype=np.float32)

    def materialize(self):
        rng = np.random.default_rng(self.seed)
        x = rng.standard_normal((self.n, self.hw, self.hw, 3),
                                dtype=np.float32)
        # learnable labels: class = argmax of 'classes' fixed random
        # projections of the image (a linear teacher)
        y = np.argmax(x.reshape(self.n, -1) @ self._teacher(),
                      axis=1).astype(np.int32)
        return x, y

    def materialize_val(self, n_val: int = 256):
        """Held-out samples from the SAME linear teacher (fresh inputs,
        disjoint RNG stream) — validation accuracy on these measures
        generalization, not memorization."""
        rngv = np.random.default_rng(self.seed + 9999)
        xv = rngv.standard_normal((n_val, self.hw, self.hw, 3),
                                  dtype=np.float32)
        yv = np.argmax(xv.reshape(n_val, -1) @ self._teacher(),
                       axis=1).astype(np.int32)
        return xv, yv


def cifar_like_batches(batch_size: int, *, steps: Optional[int] = None,
                       n: int = 512, hw: int = 32, classes: int = 10,
                       seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    x, y = SyntheticImageDataset(n=n, hw=hw, classes=classes,
                                 seed=seed).materialize()
    rng = np.random.default_rng(seed + 1)
    i = 0
    while steps is None or i < steps:
        idx = rng.integers(0, n, size=batch_size)
        yield {"image": x[idx], "label": y[idx]}
        i += 1


def mlm_batches(batch_size: int, seq_len: int, vocab: int, *,
                steps: Optional[int] = None, mask_id: int = 1,
                mask_rate: float = 0.15, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
    """Token batches with BERT-style masking. ``labels`` hold the original
    token everywhere; ``masked`` marks which positions were replaced by
    ``mask_id`` (the MLM loss averages only there).

    Sequences are successor chains (t[j+1] = t[j] + 1 mod usable vocab) so a
    masked token IS predictable from its neighbours — pure-noise tokens
    would make the masked-LM objective unlearnable and CI couldn't assert
    a decreasing loss."""
    rng = np.random.default_rng(seed)
    usable = vocab - 2
    i = 0
    while steps is None or i < steps:
        start = rng.integers(0, usable, size=(batch_size, 1))
        ids = (2 + (start + np.arange(seq_len)[None, :]) % usable).astype(
            np.int32)
        labels = ids.copy()
        masked = rng.random((batch_size, seq_len)) < mask_rate
        ids = np.where(masked, mask_id, ids).astype(np.int32)
        yield {"ids": ids, "labels": labels, "masked": masked,
               "mask": np.ones((batch_size, seq_len), np.int32)}
        i += 1
