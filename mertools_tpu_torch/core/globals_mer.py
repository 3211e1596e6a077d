"""MER label maps and feature-store directory names (the port's copy of
what it uses from ``mertools_tpu/core/globals_mer.py``).

Values are part of the MER challenge protocol (reference
``MERBench/toolkit/globals.py:2-5``); the encoder-name constants and the
unimodal rankings of top-N fusion come with that fusion (ROADMAP A7).
"""

from __future__ import annotations

EMOS_MER = ["neutral", "angry", "happy", "sad", "worried", "surprise"]
EMO2IDX_MER = {emo: idx for idx, emo in enumerate(EMOS_MER)}

# Sentinel used for missing valence labels
# (reference: MERBench/toolkit/dataloader/mer2023.py:97-101)
MISSING_VAL = -10.0


def feature_dir_name(model_name: str, level: str) -> str:
    """Feature-store directory name for (encoder, level).

    level: "UTT" (one vector per clip) or "FRA" (frame/token sequence).
    """
    if level not in ("UTT", "FRA"):
        raise ValueError(f"level must be UTT or FRA, got {level!r}")
    return f"{model_name}-{level}"
