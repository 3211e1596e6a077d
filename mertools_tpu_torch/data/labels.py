"""Label archives (the port's copy of ``mertools_tpu/data/labels.py``).

Reference layout (``MERBench/toolkit/dataloader/mer2023.py:86-104``):
``label-6way.npz`` holds ``{split}_corpus`` object arrays, each a dict
``{clip_name: {"emo": str, "val": float}}``. Emotion strings map through
``EMO2IDX_MER``; missing valence becomes the sentinel -10. An archive that
either package writes reads the same in both.
"""

from __future__ import annotations

import numpy as np

from ..core.globals_mer import EMO2IDX_MER, MISSING_VAL


def read_names_labels(label_path: str, split: str, debug: bool = False
                      ) -> tuple[list[str], np.ndarray, np.ndarray]:
    """Returns (names, emo_idx (N,), val (N,)) for one split."""
    archive = np.load(label_path, allow_pickle=True)
    key = f"{split}_corpus"
    if key not in archive:
        raise KeyError(f"{label_path} has no split {split!r}; keys: {list(archive.keys())}")
    corpus = archive[key].tolist()
    names, emos, vals = [], [], []
    for name, label in corpus.items():
        names.append(name)
        emo = label.get("emo", 0)  # valence-only datasets (CMU/SIMS) omit emo
        emos.append(EMO2IDX_MER[emo] if isinstance(emo, str) else int(emo))
        val = label.get("val", "")
        vals.append(MISSING_VAL if val == "" or val is None else float(val))
    if debug:
        names, emos, vals = names[:100], emos[:100], vals[:100]
    return names, np.asarray(emos, np.int32), np.asarray(vals, np.float32)


def write_label_archive(label_path: str, corpora: dict[str, dict]) -> None:
    """Write ``{split: {name: {"emo": str|int, "val": float}}}`` archives."""
    arrays = {f"{split}_corpus": np.array(corpus, dtype=object)
              for split, corpus in corpora.items()}
    np.savez_compressed(label_path, **arrays)
