"""Open-vocabulary label parsing — the port's copy of ``string_to_list``
from ``mertools_tpu/ops/ov_metrics.py`` (the OV metrics follow in a later
slice)."""

from __future__ import annotations

import ast

import numpy as np


def string_to_list(value) -> list:
    """Parse "['a', 'b']"-style strings; pass lists through; ''/NaN -> []
    (reference functions.py:609-631)."""
    if isinstance(value, np.ndarray):
        value = value.tolist()
    if isinstance(value, list):
        return value
    if value is None or value == "":
        return []
    try:
        import pandas as pd

        if pd.isna(value):
            return []
    except (TypeError, ValueError):
        pass
    value = str(value).strip()
    if value.startswith("["):
        try:
            return [str(x) for x in ast.literal_eval(value)]
        except (ValueError, SyntaxError):
            value = value.strip("[]")
    return [part.strip().strip("'\"") for part in value.split(",") if part.strip()]
