"""Open-vocabulary (OV) emotion metrics — the port's copy of
``mertools_tpu/ops/ov_metrics.py``.

Two regimes from the reference:

1. **MER2024 OV** (``MER2024/main-ov.py:35-120``): per-sample synonym groups
   (originally produced by GPT-3.5) map labels to a group representative
   (first element of its group); set accuracy = |gt∩pred| / |pred|, recall =
   |gt∩pred| / |gt|, averaged over samples, final score = mean(acc, recall).
   In-tree anchors: acc 0.5818 / recall 0.4978 / avg 0.5398.

2. **Emotion-wheel metric** (``my_affectgpt/evaluation/wheel.py:310-520``):
   labels map level3->level2 via ``format_mapping`` (take the sorted-first),
   level2->level1 via ``raw_mapping``, then level1 -> a wheel cluster center
   at level1 or level2 ("case3"); unmappable labels are dropped; per-sample
   set precision/recall; F1 per wheel; mean over the 5 wheels.

All mapping tables are data (emotion-wheel sheets / synonym archives) passed
in as plain dicts; loaders for the reference's formats are provided.
"""

from __future__ import annotations

import ast
from typing import Mapping, Sequence

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


# ---------------------------------------------------------------------------
# Emotion-wheel machinery
# ---------------------------------------------------------------------------
def wheel_rows_to_map(rows: Sequence[tuple]) -> dict:
    """(level1, level2, level3) rows (blank = carry previous) ->
    {level1: {level2: [level3...]}} (reference read_wheel_to_map)."""
    store: dict = {}
    l1 = l2 = ""
    for row in rows:
        r1, r2, r3 = (row + ("", "", ""))[:3] if len(row) < 3 else row[:3]
        if r1:
            l1 = r1
        if r2:
            l2 = r2
        l3 = r3 if r3 else ""
        l1k, l2k, l3k = l1.lower().strip(), l2.lower().strip(), l3.lower().strip()
        store.setdefault(l1k, {}).setdefault(l2k, [])
        if l3k:
            store[l1k][l2k].append(l3k)
    return store


def wheel_cluster_map(wheel: Mapping, level: str = "level1") -> dict:
    """Nested wheel map -> {word: cluster center} (func_get_wheel_cluster)."""
    out: dict = {}
    if level == "level1":
        for l1, sub in wheel.items():
            out[l1] = l1
            for l2, l3s in sub.items():
                out[l2] = l1
                for l3 in l3s:
                    out[l3] = l1
    elif level == "level2":
        for l1, sub in wheel.items():
            for l2, l3s in sub.items():
                out[l2] = l2
                for l3 in l3s:
                    out[l3] = l2
    else:
        raise ValueError(level)
    return out


def backward_case1(label, format_mapping, raw_mapping=None, wheel_map=None):
    if label not in format_mapping:
        return ""
    return sorted(format_mapping[label])[0]


def backward_case2(label, format_mapping, raw_mapping, wheel_map=None):
    stage1 = backward_case1(label, format_mapping)
    if stage1 == "":
        return ""
    return sorted(raw_mapping[stage1])[0]


def backward_case3(label, format_mapping, raw_mapping, wheel_map):
    if label not in format_mapping:
        return ""
    level1_whole = []
    for fmt in format_mapping[label]:
        level1_whole.extend(raw_mapping.get(fmt, []))
    for l1 in sorted(level1_whole):  # sorted -> deterministic choice
        if l1 in wheel_map:
            return wheel_map[l1]
    return ""


def map_labels(labels, format_mapping, raw_mapping, wheel_map, metric="case1"):
    fn = {"case1": backward_case1, "case2": backward_case2,
          "case3": backward_case3}[metric.split("_")[0]]
    out = []
    for label in labels:
        mapped = fn(label, format_mapping, raw_mapping, wheel_map)
        if mapped != "":
            out.append(mapped)
    return out


def openset_overlap_rate(name2gt: Mapping, name2pred: Mapping,
                         format_mapping=None, raw_mapping=None,
                         wheel_map=None, metric="case1",
                         process_names=None) -> tuple[float, float]:
    """Per-sample set accuracy/recall after synonym/wheel mapping
    (wheel.py:400-470). Samples whose mapped GT is empty are skipped."""
    format_mapping = format_mapping or {}
    raw_mapping = raw_mapping or {}
    names = process_names if process_names is not None else list(name2gt)
    accuracy, recall = [], []
    for name in names:
        gt = [x.lower().strip() for x in string_to_list(name2gt[name])]
        gt = set(map_labels(gt, format_mapping, raw_mapping, wheel_map, metric))
        pred = [x.lower().strip() for x in string_to_list(name2pred[name])]
        pred = set(map_labels(pred, format_mapping, raw_mapping, wheel_map, metric))
        if len(gt) == 0:
            continue
        if len(pred) == 0:
            accuracy.append(0.0)
            recall.append(0.0)
        else:
            accuracy.append(len(gt & pred) / len(pred))
            recall.append(len(gt & pred) / len(gt))
    # every sample may filter out under a sparse wheel map (MER2026 wheel.py
    # guards this case to 0 rather than nan)
    return (float(np.mean(accuracy)) if accuracy else 0.0,
            float(np.mean(recall)) if recall else 0.0)


def wheel_metric_calculation(name2gt, name2pred, wheels: Mapping[str, Mapping],
                             format_mapping, raw_mapping, level="level1",
                             process_names=None) -> list[float]:
    """Mean [F, precision, recall] over the wheels at one cluster level
    (wheel.py:473-520)."""
    scores = []
    for wheel_name in sorted(wheels):
        wheel_map = wheel_cluster_map(wheels[wheel_name], level)
        precision, recall = openset_overlap_rate(
            name2gt, name2pred, format_mapping, raw_mapping, wheel_map,
            metric=f"case3_{wheel_name}_{level}", process_names=process_names)
        f = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        scores.append([f, precision, recall])
    return np.mean(scores, axis=0).tolist()


def save_wheel_mapping(path: str, format_mapping: Mapping,
                       raw_mapping: Mapping, wheels: Mapping[str, Mapping]):
    """Write the precomputed-mapping npz MER2026-T2 consumes
    (``config.OUTSIDE_WHEEL_MAPPING`` — wheel.py:112-118 loads
    format_mapping / raw_mapping / wheel_map_whole where
    ``wheel_map_whole[wheelN][levelK]`` is a level1->cluster map)."""
    wheel_map_whole = {
        name: {level: wheel_cluster_map(wheel, level)
               for level in ("level1", "level2")}
        for name, wheel in wheels.items()}
    np.savez_compressed(path, format_mapping=dict(format_mapping),
                        raw_mapping=dict(raw_mapping),
                        wheel_map_whole=wheel_map_whole)
    return path


def load_wheel_mapping(path: str) -> tuple[dict, dict, dict]:
    """(format_mapping, raw_mapping, wheel_map_whole) from the npz layout
    above — interoperable with reference-produced mapping files."""
    z = np.load(path, allow_pickle=True)
    return (z["format_mapping"].item(), z["raw_mapping"].item(),
            z["wheel_map_whole"].item())


# ---------------------------------------------------------------------------
# MER2024 OV metric
# ---------------------------------------------------------------------------
def mer2024_ov_metric(name2gt: Mapping, name2pred: Mapping,
                      name2synonyms: Mapping[str, Sequence[Sequence[str]]],
                      ) -> dict:
    """Set-level OV score with per-sample synonym groups (main-ov.py:73-113).

    name2synonyms: name -> list of synonym groups; every member maps to the
    group's first element.
    """
    accuracy, recall = [], []
    for name in name2synonyms:
        synonym_map = {}
        for group in name2synonyms[name]:
            for member in group:
                synonym_map[member] = group[0]
        gt = set(synonym_map.get(x.lower(), x.lower())
                 for x in string_to_list(name2gt[name]))
        pred = set(synonym_map.get(x.lower(), x.lower())
                   for x in string_to_list(name2pred[name]))
        if len(pred) == 0:
            accuracy.append(0.0)
            recall.append(0.0)
        else:
            accuracy.append(len(gt & pred) / len(pred))
            recall.append(len(gt & pred) / len(gt))
    acc, rec = float(np.mean(accuracy)), float(np.mean(recall))
    return {"accuracy": acc, "recall": rec, "avg_score": float(np.mean([acc, rec]))}


def read_wheel_table(path: str) -> dict:
    """Read one emotion-wheel file into {level1: {level2: [level3...]}}.

    Mirrors ``wheel.py read_wheel_to_map``: columns level1/level2/level3 with
    blank cells forward-filled from the row above. Accepts .csv and .xlsx
    (dependency-free reader, io/xlsx.py).
    """
    rows = []
    if path.endswith(".xlsx"):
        from ..io.xlsx import read_xlsx_records

        rows = read_xlsx_records(path)
    else:
        import csv

        with open(path, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f))

    def blank(v):
        return v is None or (isinstance(v, float) and np.isnan(v)) or \
            str(v).strip() == ""

    store: dict = {}
    l1 = l2 = l3 = ""
    for r in rows:
        if not blank(r.get("level1")):
            l1 = str(r["level1"])
        if not blank(r.get("level2")):
            l2 = str(r["level2"])
        if not blank(r.get("level3")):
            l3 = str(r["level3"])
        l1k, l2k, l3k = (x.lower().strip() for x in (l1, l2, l3))
        store.setdefault(l1k, {}).setdefault(l2k, [])
        if l3k and l3k not in store[l1k][l2k]:
            store[l1k][l2k].append(l3k)
    return store


def load_wheels(wheel_root: str) -> dict:
    """All wheel*.{csv,xlsx} files under a directory -> {name: wheel_map}
    (wheel.py:49-55)."""
    import glob as _glob
    import os as _os

    wheels = {}
    for path in sorted(_glob.glob(_os.path.join(wheel_root, "wheel*"))):
        if not (path.endswith(".csv") or path.endswith(".xlsx")):
            continue
        name = _os.path.splitext(_os.path.basename(path))[0]
        wheels[name] = read_wheel_table(path)
    return wheels
