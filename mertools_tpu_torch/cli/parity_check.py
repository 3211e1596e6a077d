"""Feature-store parity harness — port of ``mertools_tpu/cli/parity_check.py``
(the BASELINE.md contracts).

Store mode (<1e-3 contract):

    python -m mertools_tpu_torch.cli.parity_check \
        --reference_store=/path/to/torch-produced/hubert-large-UTT \
        --our_store=/path/to/ours/hubert-large-UTT [--tol=1e-3]

Compares every clip npy present in both stores: max/mean absolute error,
relative error, shape mismatches. Exit code 1 when any clip exceeds the
tolerance — usable in CI and against cached reference features.

Judge mode (``--judge``, token-exactness against a reference wrapper's
responses) runs the preference judges, which are not ported yet: it exits
naming ROADMAP A13.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def compare_stores(reference_store: str, our_store: str, tol: float = 1e-3,
                   limit: int = 0) -> dict:
    ref_names = {f[:-4] for f in os.listdir(reference_store)
                 if f.endswith(".npy")}
    our_names = {f[:-4] for f in os.listdir(our_store) if f.endswith(".npy")}
    common = sorted(ref_names & our_names)
    if limit:
        common = common[:limit]
    stats = {"n_compared": len(common), "n_ref_only": len(ref_names - our_names),
             "n_ours_only": len(our_names - ref_names), "shape_mismatch": [],
             "over_tol": [], "max_abs": 0.0, "mean_abs": 0.0}
    total = 0.0
    for name in common:
        a = np.load(os.path.join(reference_store, name + ".npy"))
        b = np.load(os.path.join(our_store, name + ".npy"))
        if a.shape != b.shape:
            stats["shape_mismatch"].append((name, a.shape, b.shape))
            continue
        err = float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())
        total += float(np.abs(a.astype(np.float64) - b).mean())
        stats["max_abs"] = max(stats["max_abs"], err)
        if err > tol:
            stats["over_tol"].append((name, err))
    stats["mean_abs"] = total / max(len(common), 1)
    return stats


def main(argv=None):
    p = argparse.ArgumentParser("parity_check")
    p.add_argument("--reference_store", default=None)
    p.add_argument("--our_store", default=None)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--limit", type=int, default=0,
                   help="compare only the first N clips")
    # judge token-exactness mode (REHEARSAL.md)
    p.add_argument("--judge", default=None,
                   help="judge family: judge parity mode (not ported yet, "
                        "ROADMAP A13)")
    p.add_argument("--reference_responses", default=None,
                   help="CSV name,response[,prompt] produced by the "
                        "reference utils/X.py wrapper at greedy settings")
    p.add_argument("--label_csv", default=None,
                   help="optional clip list (name column); defaults to "
                        "every name in --reference_responses")
    p.add_argument("--prompt", default=None,
                   help="prompt applied to every clip (else per-row "
                        "'prompt' column)")
    # judge-construction args shared with main_dpo
    for flag in ("--ckpt", "--video_dir", "--audio_dir", "--tokenizer",
                 "--video_feat_dir", "--audio_feat_dir", "--whisper",
                 "--beats", "--vicuna", "--bert", "--vit_qformer",
                 "--blip2_qformer", "--model_name"):
        p.add_argument(flag, default=None)
    p.add_argument("--input_type", default="video")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max_new_tokens", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.judge:
        raise SystemExit(f"parity_check --judge {args.judge}: judge mode runs the "
                         f"preference judges, which are not ported to "
                         f"mertools_tpu_torch yet (ROADMAP A13)")

    assert args.reference_store and args.our_store, \
        "store mode needs --reference_store and --our_store"
    s = compare_stores(args.reference_store, args.our_store, args.tol,
                       args.limit)
    print(f"compared {s['n_compared']} clips "
          f"(ref-only {s['n_ref_only']}, ours-only {s['n_ours_only']})")
    print(f"max |err| = {s['max_abs']:.2e}, mean |err| = {s['mean_abs']:.2e}, "
          f"tol = {args.tol:g}")
    if s["shape_mismatch"]:
        print(f"SHAPE MISMATCH on {len(s['shape_mismatch'])} clips, e.g. "
              f"{s['shape_mismatch'][:3]}")
    if s["over_tol"]:
        worst = sorted(s["over_tol"], key=lambda kv: -kv[1])[:5]
        print(f"FAIL: {len(s['over_tol'])} clips over tolerance; worst: {worst}")
        sys.exit(1)
    if s["shape_mismatch"]:
        sys.exit(1)
    print("PASS")
    return s


if __name__ == "__main__":
    main()
