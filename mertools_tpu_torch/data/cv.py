"""Cross-validation splits (the port's copy of ``mertools_tpu/data/cv.py``).

Reference protocol (``MERBench/toolkit/dataloader/mer2023.py:108-135``): the
train corpus is shuffled once and cut into ``num_folder`` contiguous chunks
(last chunk takes the remainder); fold *i* evaluates on chunk *i* and trains
on the rest. The reference shuffle is unseeded; here the PRNG is explicit so
runs are reproducible, and one seed gives the same folds in both packages:
one ``rng.shuffle`` of ``arange(n)``.
"""

from __future__ import annotations

import numpy as np


def kfold_indices(n: int, num_folds: int = 5, rng: np.random.Generator | None = None
                  ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Returns [(train_idx, eval_idx)] * num_folds."""
    rng = rng or np.random.default_rng()
    indices = np.arange(n)
    rng.shuffle(indices)

    per = n // num_folds
    chunks = [indices[per * i: per * (i + 1)] for i in range(num_folds - 1)]
    chunks.append(indices[per * (num_folds - 1):])
    assert sum(len(c) for c in chunks) == n

    splits = []
    for i in range(num_folds):
        eval_idx = chunks[i]
        train_idx = np.concatenate([chunks[j] for j in range(num_folds) if j != i])
        splits.append((train_idx, eval_idx))
    return splits
