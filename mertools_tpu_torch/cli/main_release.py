"""Training/evaluation CLI — the ``main-release.py`` equivalent (port of
``mertools_tpu/cli/main_release.py``).

Honors the reference's flags (``MERBench/main-release.py:89-127``) so the
published ``run.sh`` recipes translate 1:1:

    python -m mertools_tpu_torch.cli.main_release --dataset=MER2023 \
        --audio_feature=chinese-hubert-large-UTT --text_feature=... \
        --video_feature=... --feat_type=utt --model=attention --gpu=0

  * It trains on the card (``--device cuda``, card ``--gpu``) unless
    ``--device cpu`` is given; on a host without a card ``cuda`` raises.
  * Feature roots resolve from the path registry
    ($MERTOOLS_TPU_CONFIG yaml) or ``--features_root``.
  * 5-fold CV + random hyperparameter search + npz artifacts follow
    MERBench/main-release.py:130-272, incl. feat_scale 1/6/12 and the
    cv_/testN_ result filename conventions.
  * Every feature-level fusion model of the zoo runs (``--model=attention``,
    ``tfn``, ``lmf``, ``misa``, ``mmim``, ``mfn``, ``graph_mfn``, ``mfm``,
    ``mctn``, ``mult``, ``ef_lstm``, ``lf_dnn``), and top-N fusion with
    ``--fusion_topn=N --model=attention_topn``.
  * Raw-input fine-tuning: ``--model=e2e_model --e2e_name=NAME`` with
    ``--raw_audio_root`` / ``--trans_csv`` / ``--face_npy_root`` (by NAME's
    modality) and ``--pretrain_dir`` holding ``NAME/`` (``config.json`` and
    its weights); ``--savemodel`` writes each fold's best-epoch backbone to
    ``{save_root}/model/fold{i}_backbone`` (``config.json`` +
    ``pytorch_model.bin``), which the extraction CLIs read back with
    ``--finetuned_ckpt``. ``--model=videomae_pretrain`` exits naming ROADMAP
    A7b.
  * The result files' ``args`` leave out the run-time entries whose names
    start with ``_`` (the pretrained backbone's weights, a tokenizer).
"""

from __future__ import annotations

import argparse
import ast
import os
import time

import numpy as np

from ..core.config import Args, configure_from_env, load_yaml, random_select
from ..core.device import resolve_device
from ..core.profiling import trace
from ..core.registry import registry
from ..data.loaders import get_loader
from ..ops import metrics
from ..train.loop import run_cv

_TUNE_YAML = os.path.join(os.path.dirname(__file__), "..", "train", "model_tune.yaml")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("mertools_tpu_torch main-release")
    # datasets
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--train_dataset", type=str, default=None)
    p.add_argument("--test_dataset", type=str, default=None)
    p.add_argument("--save_root", type=str, default="./saved")
    p.add_argument("--features_root", type=str, default=None,
                   help="root dir holding {feature_name}/ stores (overrides registry)")
    p.add_argument("--label_path", type=str, default=None)
    p.add_argument("--test_features_root", type=str, default=None,
                   help="cross-corpus: feature root of the TEST dataset")
    p.add_argument("--test_label_path", type=str, default=None)
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--savemodel", action="store_true", default=False)
    p.add_argument("--save_iters", type=int, default=10 ** 8)
    # features
    p.add_argument("--audio_feature", type=str, default=None)
    p.add_argument("--text_feature", type=str, default=None)
    p.add_argument("--video_feature", type=str, default=None)
    p.add_argument("--feat_type", type=str, default="utt",
                   choices=["utt", "frm_align", "frm_unalign"])
    p.add_argument("--feat_scale", type=int, default=None)
    # noise-robustness sweeps (MER2024/main-release.py:96-97): snr-tagged
    # feature stores for train vs test
    p.add_argument("--train_snr", type=str, default=None)
    p.add_argument("--test_snr", type=str, default=None)
    # top-N fusion (MER2024/main-release.py:98-99)
    p.add_argument("--fusion_topn", type=int, default=None)
    p.add_argument("--fusion_modality", type=str, default="AVT",
                   choices=["AVT", "AV", "AT", "VT"])
    # e2e (raw-input fine-tuning; e2e_data.py roots)
    p.add_argument("--e2e_name", type=str, default=None)
    p.add_argument("--e2e_dim", type=int, default=None)
    p.add_argument("--raw_audio_root", type=str, default=None)
    p.add_argument("--trans_csv", type=str, default=None)
    p.add_argument("--face_npy_root", type=str, default=None)
    p.add_argument("--pretrain_dir", type=str, default=None)
    p.add_argument("--e2e_nseg", type=int, default=None)
    p.add_argument("--e2e_seglen", type=int, default=None)
    p.add_argument("--mae_mask_ratio", type=float, default=None)
    p.add_argument("--mae_image_size", type=int, default=None)
    # model
    p.add_argument("--n_classes", type=int, default=None)
    p.add_argument("--hyper_path", type=str, default=None)
    p.add_argument("--model", type=str, default=None)
    # training
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr_adjust", type=str, default="case1")
    p.add_argument("--l2", type=float, default=1e-5)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--print_iters", type=int, default=10 ** 8)
    p.add_argument("--seed", type=int, default=None,
                   help="explicit PRNG seed (reference is unseeded; default: time-based)")
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p


def resolve_paths(args: Args) -> None:
    """Fill audio/text/video feature roots + label path from the registry."""
    reg = configure_from_env()
    if args.train_dataset:
        # cross-corpus: the CROSSDIS/CROSSDIM loaders resolve per-dataset
        # paths themselves (registry or --{test_,}features_root overrides)
        for mod in ("audio", "text", "video"):
            args[f"{mod}_root"] = None
        return
    if args.features_root is None and args.dataset in reg:
        args.features_root = reg[args.dataset].features
        if args.label_path is None:
            args.label_path = reg[args.dataset].label
    if not args.features_root:
        raise SystemExit("need --features_root or a registry entry")
    if not args.label_path:
        raise SystemExit("need --label_path or a registry entry")
    for mod, feat in (("audio", args.audio_feature), ("text", args.text_feature),
                      ("video", args.video_feature)):
        if args.fusion_topn or args.model == "e2e_model":
            # top-N picks its stores from the rank lists; e2e reads raw inputs
            args[f"{mod}_root"] = None
            continue
        if not feat:
            raise SystemExit(f"--{mod}_feature is required")
        args[f"{mod}_root"] = os.path.join(args.features_root, feat)


def modality_tag(features: list[str]) -> str:
    uniq = len(set(f for f in features if f))
    return {0: "others", 1: "unimodal", 2: "bimodal", 3: "trimodal"}.get(uniq, "others")


def check_ported(args: Args) -> None:
    """Exit naming the ROADMAP item of what this package does not run yet,
    or what a flag needs beside it."""
    if args.model == "videomae_pretrain":
        raise SystemExit("--model=videomae_pretrain: masked video pretraining "
                         "is not ported to mertools_tpu_torch yet (ROADMAP A7b, "
                         "after A9b's VideoMAE)")
    if args.fusion_topn and args.model != "attention_topn":
        # the JAX package reads the tune space of --model before it
        # defaults the model, so a missing --model raises KeyError: None
        raise SystemExit(f"--fusion_topn trains --model=attention_topn, got "
                         f"--model={args.model}")
    if args.model == "attention_topn" and not args.fusion_topn:
        raise SystemExit("--model=attention_topn needs --fusion_topn=N")
    if args.model not in registry.names("model"):
        raise SystemExit(f"--model={args.model}: not a fusion model; it runs "
                         f"{', '.join(registry.names('model'))}")
    if args.model == "e2e_model" and not args.e2e_name:
        raise SystemExit("--model=e2e_model needs --e2e_name")
    if args.savemodel and args.model != "e2e_model":
        print(f"--savemodel: --model={args.model} has no fine-tuned backbone; "
              f"nothing is saved")


def main(argv=None):
    ns, unknown = build_parser().parse_known_args(argv)
    args = Args(vars(ns))
    check_ported(args)
    device = resolve_device(f"cuda:{args.gpu}" if args.device == "cuda" else "cpu",
                            fp32=True)
    # model-specific hyperparameters (hidden_dim, dropout, rank, ...) arrive
    # as free --key=value flags and override the random search, mirroring the
    # reference's merge_args_config overlay (functions.py:144-150)
    for tok in unknown:
        if not (tok.startswith("--") and "=" in tok):
            raise SystemExit(f"unknown arg {tok!r}")
        k, v = tok[2:].split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        args[k] = v

    # feat_scale from feat_type (main-release.py:130-142)
    if args.feat_type == "utt":
        args.feat_scale = 1
    elif args.feat_scale is None:
        args.feat_scale = 6 if args.feat_type == "frm_align" else 12
    if (args.feat_type in ("frm_align", "frm_unalign") and not args.fusion_topn
            and args.model != "e2e_model"):
        for f in (args.audio_feature, args.text_feature, args.video_feature):
            if not (f or "").endswith("FRA"):
                raise SystemExit(f"{args.feat_type} needs -FRA features, got {f}")

    # hyperparameters: fixed yaml or random search (main-release.py:158-165)
    seed = args.seed if args.seed is not None else int(time.time()) % 2 ** 31
    rng = np.random.default_rng(seed)
    tune_path = args.hyper_path or os.path.normpath(_TUNE_YAML)
    space = load_yaml(tune_path)[args.model]
    if args.hyper_path:  # fixed config file: scalars (or singleton lists)
        chosen = {k: (v[0] if isinstance(v, list) else v) for k, v in space.items()}
    else:
        chosen = random_select(space, rng)
    for k, v in chosen.items():
        if args.get(k) is None:
            args[k] = v
    print("args:", {k: v for k, v in args.items() if v is not None})

    resolve_paths(args)
    whole_features = [args.audio_feature, args.text_feature, args.video_feature]
    save_root = f"{args.save_root}-cross" if args.train_dataset else args.save_root
    save_root = f"{save_root}-{modality_tag(whole_features)}"
    res_root = os.path.join(save_root, "result")
    os.makedirs(res_root, exist_ok=True)

    print("====== Reading Data =======")
    loader = get_loader(args)
    train_set, folds, test_sets = loader.load(seed=seed)
    args.audio_dim, args.text_dim, args.video_dim = (
        train_set.adim, train_set.tdim, train_set.vdim)
    print(f"train: {len(train_set)}; folds: {len(folds)}; "
          f"tests: { {k: len(v) for k, v in test_sets.items()} }")

    print("====== Training and Evaluation =======")
    with trace():  # active when MERTPU_TRACE_DIR is set
        result = run_cv(args, train_set, test_sets, seed=seed, folds=folds,
                        calc_fn=loader.calc_results, device=device)
    result.chosen_hp = chosen  # a sweep re-runs the winning config

    feature_name = "+".join(sorted(set(f for f in whole_features if f)))
    model_name = f"{args.model}+{args.feat_type}+{args.e2e_name}"
    prefix = f"features:{feature_name}_dataset:{args.dataset}_model:{model_name}"
    if args.test_snr is not None:  # MER2024 result naming (:188-191)
        prefix += f"_trainsnr:{args.train_snr}_testsnr:{args.test_snr}"
    if args.fusion_topn is not None:
        prefix += f"_fusiontopn:{args.fusion_topn}_modality:{args.fusion_modality}"
    stamp = time.time()
    saved_args = np.array({k: v for k, v in args.items() if not k.startswith("_")},
                          dtype=object)

    save_path = os.path.join(res_root, f"cv_{prefix}_{result.cv_str}_{stamp}.npz")
    np.savez_compressed(save_path, args=saved_args,
                        cv=np.array(result.cv, dtype=object),
                        duration=result.duration)
    print(f"save results in {save_path}")

    for name, tres in result.test_results.items():
        out_str = metrics.cv_summary_str(
            {k: tres[k] for k in ("emofscore", "emoacc", "valmse") if k in tres})
        tpath = os.path.join(res_root, f"{name}_{prefix}_{out_str}_{stamp}.npz")
        np.savez_compressed(
            tpath, args=saved_args,
            emoprobs=tres.get("emoprobs", np.zeros(0)),
            emolabels=tres.get("emolabels", np.zeros(0)),
            valpreds=tres.get("valpreds", np.zeros(0)),
            vallabels=tres.get("vallabels", np.zeros(0)))
        print(f"save results in {tpath}")
    return result


if __name__ == "__main__":
    main()
