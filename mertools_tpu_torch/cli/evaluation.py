"""Challenge scoring + submission CLI — port of
``mertools_tpu/cli/evaluation.py`` (Track1 ``evaluation.py`` /
``submission.py`` equivalents), scored by the port's ``ops/metrics``.

    # result npz (emo_probs + names) -> submission CSV (name, discrete)
    python -m mertools_tpu_torch.cli.evaluation submission \
        --result_npz=test1_....npz --name_csv=candidates.csv --save_csv=sub.csv

    # weighted-F1 of a submission vs ground truth
    python -m mertools_tpu_torch.cli.evaluation score --label_csv=gt.csv \
        --submission_csv=sub.csv

Reference: ``MER2026/MER2026_Track1/submission.py`` (argmax probs ->
idx2emo -> CSV) and ``evaluation.py:23-46`` (weighted F1 over the 6 MER
emotions).
"""

from __future__ import annotations

import argparse
import csv

import numpy as np

from ..core.globals_mer import EMO2IDX_MER, EMOS_MER


def _read_col(path, col):
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return [r["name"] for r in rows], [r.get(col, "") for r in rows]


def cmd_submission(args):
    data = np.load(args.result_npz, allow_pickle=True)
    pick = lambda *keys: next((np.asarray(data[k].tolist()) for k in keys
                               if k in data), None)
    emo_probs = pick("emo_probs", "emoprobs")
    preds = [EMOS_MER[i] for i in emo_probs.argmax(1)]
    if args.name_csv:
        names, _ = _read_col(args.name_csv, "name")
    else:
        names = [str(n) for n in data["names"]]
    assert len(names) == len(preds), (len(names), len(preds))
    # MER2023 submissions carry a valence column too (write_to_csv_pred,
    # MER2023/main-release.py:445-455)
    vals = pick("val_preds", "valpreds")
    if vals is not None and vals.size:
        vals = vals.reshape(-1)
        assert len(vals) == len(preds), \
            f"valence count {len(vals)} != prediction count {len(preds)}"
    else:
        vals = None
    with open(args.save_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        if vals is not None:
            w.writerow(["name", "discrete", "valence"])
            w.writerows(zip(names, preds, [f"{v:.4f}" for v in vals]))
        else:
            w.writerow(["name", "discrete"])
            w.writerows(zip(names, preds))
    print(f"wrote {len(names)} predictions -> {args.save_csv}")


def cmd_score(args):
    from ..ops.metrics import accuracy, mean_squared_error, weighted_f1

    names_gt, emos_gt = _read_col(args.label_csv, "discrete")
    names_p, emos_p = _read_col(args.submission_csv, "discrete")
    name2pred = dict(zip(names_p, emos_p))
    y, yhat = [], []
    for name, emo in zip(names_gt, emos_gt):
        if name not in name2pred:
            continue
        y.append(EMO2IDX_MER[emo])
        yhat.append(EMO2IDX_MER[name2pred[name]])
    waf = weighted_f1(y, yhat)
    acc = accuracy(y, yhat)
    # MER2023 test1/test2 score valence too: combined = WAF - 0.25*MSE
    # (report_results_on_test1_test2, MER2023/main-release.py:457-494)
    _, vals_gt = _read_col(args.label_csv, "valence")
    _, vals_p = _read_col(args.submission_csv, "valence")
    if any(vals_gt) and any(vals_p):
        name2val = dict(zip(names_p, vals_p))
        v, vhat = [], []
        for name, val in zip(names_gt, vals_gt):
            if name in name2val and val != "" and name2val[name] != "":
                v.append(float(val))
                vhat.append(float(name2val[name]))
        if not v:  # valence columns exist but never pair up by name
            print(f"WAF={waf:.4f} ACC={acc:.4f} (n={len(y)}; no paired "
                  f"valence values)")
            return waf, acc
        mse = float(mean_squared_error(v, vhat))
        combined = waf - 0.25 * mse
        print(f"WAF={waf:.4f} ACC={acc:.4f} valMSE={mse:.4f} "
              f"combined={combined:.4f} (n={len(y)})")
        return waf, acc, mse, combined
    print(f"WAF={waf:.4f} ACC={acc:.4f} (n={len(y)})")
    return waf, acc


def main(argv=None):
    p = argparse.ArgumentParser("evaluation")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("submission")
    s.add_argument("--result_npz", required=True)
    s.add_argument("--name_csv", default=None,
                   help="candidate list; default: names stored in the npz")
    s.add_argument("--save_csv", required=True)
    s.set_defaults(fn=cmd_submission)

    e = sub.add_parser("score")
    e.add_argument("--label_csv", required=True)
    e.add_argument("--submission_csv", required=True)
    e.set_defaults(fn=cmd_score)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
