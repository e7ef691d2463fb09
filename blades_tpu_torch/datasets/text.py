"""Synthetic federated text-classification dataset.

Counterpart: ``blades_tpu/datasets/text.py:20-68``, ported line for line on
the same ``np.random.RandomState(seed + 4321)`` (each row's ``rng.choice``
written out as the draws it makes), so one seed gives the same int32 token
store and, through the shared partitioner (``base.py``), the same client
split. Each class draws tokens from its own Zipf-tilted unigram
distribution over a shared vocabulary; sequences have variable length and
are padded with ``pad_id`` (0), so the masked text models
(``models/text.py``) run their whole mask plumbing. The store stays int32 on
the device: no transform or normalizer touches it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from blades_tpu_torch.datasets.base import BaseDataset


class SyntheticText(BaseDataset):
    name = "synthetic_text"
    pad_id = 0

    def __init__(
        self,
        num_classes: int = 2,
        vocab_size: int = 1000,
        seq_len: int = 64,
        min_len: int = 8,
        train_size: int = 2000,
        test_size: int = 400,
        skew: float = 1.2,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.num_classes = int(num_classes)
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.min_len = int(min_len)
        self.train_size = int(train_size)
        self.test_size = int(test_size)
        self.skew = float(skew)

    def load_raw(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        rng = np.random.RandomState(self.seed + 4321)
        # per-class unigram distribution: shared Zipf body, class-specific
        # random tilt (token 0 is reserved for padding)
        usable = self.vocab_size - 1
        base = 1.0 / np.arange(1, usable + 1) ** self.skew
        probs = []
        for _ in range(self.num_classes):
            tilt = rng.rand(usable) ** 2
            p = base * tilt
            probs.append(p / p.sum())

        # rng.choice(usable, size, p) is, in the legacy RandomState, a
        # search of random_sample(size) draws in the normalized cumulative
        # sum of p; the sums are taken once a class here, not once a row
        # (O(vocab) each: a 100,000-word vocabulary took 1 ms a row)
        cdfs = [np.cumsum(p) for p in probs]
        cdfs = [c / c[-1] for c in cdfs]

        def make(n):
            y = rng.randint(0, self.num_classes, size=n)
            x = np.full((n, self.seq_len), self.pad_id, np.int32)
            lens = rng.randint(self.min_len, self.seq_len + 1, size=n)
            for i in range(n):
                draws = rng.random_sample(lens[i])
                x[i, : lens[i]] = cdfs[y[i]].searchsorted(draws, side="right") + 1
            return x, y.astype(np.int32)

        train_x, train_y = make(self.train_size)
        test_x, test_y = make(self.test_size)
        return train_x, train_y, test_x, test_y
