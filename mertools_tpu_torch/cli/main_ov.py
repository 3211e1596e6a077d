"""Open-vocabulary scoring CLI — port of ``mertools_tpu/cli/main_ov.py``
(``MER2024/main-ov.py`` + wheel evaluation of
``MER2025/MER2025_Track23/evaluation.py:96-120`` equivalents).

    # MER2024 set-level metric with precomputed synonym groups
    python -m mertools_tpu_torch.cli.main_ov mer2024 --gt_csv=gt.csv \
        --pred_csv=pred.csv --synonym_root=.../synonyms

    # emotion-wheel metric (5 wheels x level1/level2)
    python -m mertools_tpu_torch.cli.main_ov wheel --gt_csv=gt.csv \
        --pred_npz=name2openset.npz --wheel_json=wheels.json

CSV conventions follow the reference: gt column ``openset`` (list-like
string), pred column ``openset``/``pred``; synonym groups one ``{name}.npy``
per clip (main-ov.py:40-49).
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

from ..ops.ov_metrics import (load_wheels, mer2024_ov_metric,
                              string_to_list, wheel_metric_calculation)


def _read_csv_map(path, key_col, val_col):
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return {r[key_col]: r.get(val_col, "") for r in rows}


def _load_pred(pred_csv=None, pred_npz=None):
    if pred_csv:
        with open(pred_csv, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f))
        col = "openset" if rows and "openset" in rows[0] else "pred"
        return {r["name"]: r.get(col, "") for r in rows}
    data = np.load(pred_npz, allow_pickle=True)
    if "name2openset" in data:
        return dict(data["name2openset"].item())
    return dict(zip([str(n) for n in data["filenames"]],
                    [str(i) for i in data["fileitems"]]))


def _parse_synonym_groups(obj) -> list:
    """Synonym store entry -> list of groups. Reference stores the raw LLM
    response string "[['a','b'],['c']]" (main-ov.py:47-49); pre-parsed lists
    pass through."""
    if isinstance(obj, str):
        import ast as _ast

        try:
            obj = _ast.literal_eval(obj.strip())
        except (ValueError, SyntaxError):
            return []
    if not isinstance(obj, (list, tuple)):
        return []
    return [[str(m) for m in g] for g in obj
            if isinstance(g, (list, tuple))]


def cmd_mer2024(args):
    name2gt = _read_csv_map(args.gt_csv, "name", "openset")
    name2pred = _load_pred(args.pred_csv, args.pred_npz)
    name2syn = {}
    for name in name2gt:
        path = os.path.join(args.synonym_root, f"{name}.npy")
        if not os.path.exists(path):
            continue
        groups = _parse_synonym_groups(
            np.load(path, allow_pickle=True).tolist())
        name2syn[name] = [[str(m).lower() for m in g] for g in groups]
    scores = mer2024_ov_metric(name2gt, name2pred, name2syn)
    print(f"accuracy: {scores['accuracy']:.4f}")
    print(f"recall: {scores['recall']:.4f}")
    print(f"avg_score: {scores['avg_score']:.4f}")
    return scores


def cmd_wheel(args):
    name2gt = _read_csv_map(args.gt_csv, "name", "openset")
    name2pred = _load_pred(args.pred_csv, args.pred_npz)
    format_mapping, raw_mapping = {}, {}
    if args.wheel_root:  # reference layout: wheel*.{csv,xlsx} dir
        wheels = load_wheels(args.wheel_root)
    else:
        with open(args.wheel_json, encoding="utf-8") as f:
            spec = json.load(f)
        wheels = spec["wheels"]
        format_mapping = spec.get("format_mapping", {})
        raw_mapping = spec.get("raw_mapping", {})
    names = [n for n in name2gt if n in name2pred]
    out = {}
    for level in ("level1", "level2"):
        f_, p_, r_ = wheel_metric_calculation(
            name2gt, name2pred, wheels, format_mapping, raw_mapping,
            level=level, process_names=names)
        out[level] = {"f": f_, "precision": p_, "recall": r_}
        print(f"{level}: F={f_:.4f} P={p_:.4f} R={r_:.4f}")
    avg = float(np.mean([out["level1"]["f"], out["level2"]["f"]]))
    print(f"avg_F: {avg:.4f}")
    out["avg_f"] = avg
    return out


# reference-exact synonym-grouping prompt (get_openset_synonym,
# MER2024/toolkit/utils/chatgpt.py:61-79); the reference calls GPT-3.5 per
# clip — here a local LLM answers batched on the card
SYNONYM_PROMPT = (
    "Please assume the role of an expert in the field of emotions. We "
    "provide a set of emotions. Please group the emotions, with each group "
    "containing emotions with the same meaning. Directly output the "
    "results. The output format should be a list containing multiple "
    "lists. Input: ['Agree', 'agreement', 'Relaxed', 'acceptance', "
    "'pleasant', 'relaxed', 'Accept', 'positive', 'Happy'] Output: "
    "[['Agree', 'agreement', 'Accept', 'acceptance'], ['Relaxed', "
    "'relaxed'],['pleasant', 'positive', 'Happy']] "
    "Input: {merged} Output:")


def cmd_generate_synonyms(args):
    """Per-clip synonym groups from (gt ∪ pred) label sets
    (generate_openset_synonym_mer2024, main-ov.py:19-49) via the local LLM.
    Stores the raw response string per ``{name}.npy`` like the reference;
    idempotent (skips existing)."""
    from ..mllm.generate import batch_generate_texts
    from .ovlabel_extraction import _STRIP_PREFIXES, load_causal_lm

    name2gt = _read_csv_map(args.gt_csv, "name", "openset")
    name2pred = _load_pred(args.pred_csv, args.pred_npz)
    os.makedirs(args.synonym_root, exist_ok=True)
    todo = [n for n in name2gt
            if n in name2pred and not os.path.exists(
                os.path.join(args.synonym_root, f"{n}.npy"))]
    print(f"generating synonym groups for {len(todo)} clips")
    if not todo:
        return

    model, tok = load_causal_lm(args.model, args.device, args.gpu)

    def prompt_ids(name):
        merged = sorted(set(x.lower() for x in
                            string_to_list(name2gt[name])) |
                        set(x.lower() for x in
                            string_to_list(name2pred[name])))
        prompt = SYNONYM_PROMPT.format(merged=merged)
        if hasattr(tok, "apply_chat_template") and getattr(
                tok, "chat_template", None):
            return tok.apply_chat_template(
                [{"role": "user", "content": prompt}], tokenize=True,
                add_generation_prompt=True)
        return tok.encode(prompt)

    ids_by_name = {n: prompt_ids(n) for n in todo}
    texts = batch_generate_texts(
        model, ids_by_name, tok, batch=args.batch,
        max_new_tokens=args.max_new_tokens, progress=print, device=model.norm.weight.device)
    for n, text in texts.items():
        text = text.strip()
        for pre in _STRIP_PREFIXES:
            if text.startswith(pre):
                text = text[len(pre):].strip()
        for pre in (":", "："):
            if text.startswith(pre):
                text = text[len(pre):].strip()
        np.save(os.path.join(args.synonym_root, f"{n}.npy"), text)


def main(argv=None):
    p = argparse.ArgumentParser("main_ov")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("mer2024")
    m.add_argument("--gt_csv", required=True)
    m.add_argument("--pred_csv", default=None)
    m.add_argument("--pred_npz", default=None)
    m.add_argument("--synonym_root", required=True)
    m.set_defaults(fn=cmd_mer2024)

    w = sub.add_parser("wheel")
    w.add_argument("--gt_csv", required=True)
    w.add_argument("--pred_csv", default=None)
    w.add_argument("--pred_npz", default=None)
    w.add_argument("--wheel_json", default=None)
    w.add_argument("--wheel_root", default=None,
                   help="dir of wheel*.{csv,xlsx} (reference layout)")
    w.set_defaults(fn=cmd_wheel)

    g = sub.add_parser("generate-synonyms")
    g.add_argument("--gt_csv", required=True)
    g.add_argument("--pred_csv", default=None)
    g.add_argument("--pred_npz", default=None)
    g.add_argument("--synonym_root", required=True)
    g.add_argument("--model", required=True, help="HF causal-LM checkpoint")
    g.add_argument("--batch", type=int, default=8)
    g.add_argument("--max_new_tokens", type=int, default=256)
    g.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    g.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    g.set_defaults(fn=cmd_generate_synonyms)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
