"""Hyperparameter sweep, the MERBench protocol as one command (port
of ``mertools_tpu/cli/sweep.py``).

The reference protocol is "run each command 50 times (random hyperparameter
search), choose the best, run 6 times and average" (``MERBench/README.md:116``)
executed by hand. Here:

    python -m mertools_tpu_torch.cli.sweep --n_search=50 --n_repeat=6 -- \
        --dataset=MER2023 --model=attention --feat_type=utt \
        --audio_feature=... --text_feature=... --video_feature=... ...

Everything after ``--`` is passed to ``main_release`` per run (on the card
unless it carries ``--device cpu``); seeds vary per run; the best run's
hyperparameters (its ``chosen_hp``) are re-run ``n_repeat`` times as flags,
and one JSON line reports the best search score and the repeats' mean and
std.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from . import main_release


def main(argv=None):
    p = argparse.ArgumentParser("sweep")
    p.add_argument("--n_search", type=int, default=50)
    p.add_argument("--n_repeat", type=int, default=6)
    p.add_argument("--metric", type=str, default=None,
                   help="cv metric key to rank by (default: emoval if "
                        "present else emofscore)")
    p.add_argument("--base_seed", type=int, default=0)
    p.add_argument("rest", nargs=argparse.REMAINDER,
                   help="-- then main_release args")
    args = p.parse_args(argv)
    rest = [a for a in args.rest if a != "--"]

    def metric_of(result):
        cv = result.cv
        key = args.metric or ("emoval" if "emoval" in cv else "emofscore")
        return float(cv[key]), key

    print(f"=== search phase: {args.n_search} runs ===")
    best = None
    for i in range(args.n_search):
        res = main_release.main(rest + [f"--seed={args.base_seed + i}"])
        score, key = metric_of(res)
        print(f"run {i}: {key}={score:.4f}")
        if best is None or score > best[0]:
            best = (score, i, res)
    score, best_i, best_res = best
    print(f"best run {best_i}: {score:.4f}")

    # re-run the winning hyperparameters n_repeat times
    hp_args = [f"--{k}={v}" for k, v in getattr(best_res, "chosen_hp", {}).items()]
    print(f"=== repeat phase: {args.n_repeat} runs of the best config ===")
    scores = []
    for j in range(args.n_repeat):
        res = main_release.main(rest + hp_args + [f"--seed={args.base_seed + 10_000 + j}"])
        s, key = metric_of(res)
        scores.append(s)
        print(f"repeat {j}: {key}={s:.4f}")
    print(json.dumps({"best_search": score,
                      "repeat_mean": float(np.mean(scores)),
                      "repeat_std": float(np.std(scores)),
                      "n_search": args.n_search,
                      "n_repeat": args.n_repeat}))


if __name__ == "__main__":
    main()
