"""The trainer's host side in the port against the JAX package: the numpy
metrics against sklearn's (to 1e-12, with classes missing from either
side), the CMU/SIMS sign metric and the fold averaging; folds, batch plans,
alignment and ``FeatureDataset.from_raw`` bit-equal; label archives and
feature stores written by the JAX package read the same; the loaders'
protocols."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mertools_tpu.core.config import Args as JArgs
from mertools_tpu.data import cv as j_cv
from mertools_tpu.data import dataset as j_dataset
from mertools_tpu.data import feature_store as j_store
from mertools_tpu.data import labels as j_labels
from mertools_tpu.data import loaders as j_loaders
from mertools_tpu.ops import align as j_align
from mertools_tpu.ops import metrics as j_metrics
from mertools_tpu_torch.core.config import Args
from mertools_tpu_torch.core.config import random_select
from mertools_tpu_torch.data import cv as t_cv
from mertools_tpu_torch.data import dataset as t_dataset
from mertools_tpu_torch.data import feature_store as t_store
from mertools_tpu_torch.data import labels as t_labels
from mertools_tpu_torch.data import loaders as t_loaders
from mertools_tpu_torch.ops import align as t_align
from mertools_tpu_torch.ops import metrics as t_metrics


def _assert_results_equal(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v)
        else:
            assert abs(got[k] - v) <= 1e-12, (k, got[k], v)


labels_st = st.lists(st.integers(0, 5), min_size=1, max_size=40)


@settings(max_examples=150, deadline=None)
@given(y_true=labels_st, y_pred=labels_st, n_classes=st.integers(1, 6),
       seed=st.integers(0, 2 ** 31 - 1))
def test_calculate_results_matches_sklearn(y_true, y_pred, n_classes, seed):
    """WAF, accuracy and valence MSE equal sklearn's through the JAX
    package, also where some classes appear only in y_true or only in
    y_pred."""
    n = min(len(y_true), len(y_pred))
    y_true = np.asarray(y_true[:n]) % n_classes
    rng = np.random.default_rng(seed)
    probs = rng.normal(size=(n, 6)).astype(np.float32)
    probs[np.arange(n), np.asarray(y_pred[:n])] += 10.0  # argmax = y_pred
    vp = rng.normal(size=n).astype(np.float32)
    vl = rng.normal(size=n).astype(np.float32)
    _assert_results_equal(t_metrics.calculate_results(probs, y_true, vp, vl),
                          j_metrics.calculate_results(probs, y_true, vp, vl))


@pytest.mark.parametrize("case", ["mixed", "one_sided", "all_zero_but_one"])
def test_val_sign_metric_matches_jax(case):
    rng = np.random.default_rng(4)
    vl = rng.normal(size=30).astype(np.float32)
    vl[::5] = 0.0
    vp = rng.normal(size=30).astype(np.float32)
    if case == "one_sided":
        vp = np.abs(vp)          # every prediction positive
    elif case == "all_zero_but_one":
        vl = np.zeros(30, np.float32)
        vl[3] = -0.5
    _assert_results_equal(t_loaders.calc_results_val_sign(val_preds=vp, val_labels=vl),
                          j_loaders.calc_results_val_sign(val_preds=vp, val_labels=vl))


def test_fold_summaries_match_jax(rng):
    folds = [{"eval_emoacc": rng.random(), "eval_emofscore": rng.random(),
              "eval_valmse": rng.random(), "eval_loss": rng.random(),
              "test1_emoprobs": rng.normal(size=(10, 6)),
              "test1_emolabels": np.arange(10) % 6,
              "test1_valpreds": rng.normal(size=10).astype(np.float32),
              "test1_vallabels": np.zeros(10, np.float32)} for _ in range(3)]
    _assert_results_equal(t_metrics.average_folds(folds, "test1"),
                          j_metrics.average_folds(folds, "test1"))
    cv = t_metrics.cv_summary(folds)
    _assert_results_equal(cv, j_metrics.cv_summary(folds))
    assert t_metrics.cv_summary_str(cv) == j_metrics.cv_summary_str(cv)
    for name in ("emoval", "emo", "val", "loss"):
        res = {k[5:]: v for k, v in folds[0].items() if k.startswith("eval_")}
        assert t_metrics.gain_metric(res, name) == j_metrics.gain_metric(res, name)


@pytest.mark.parametrize("n,k", [(37, 5), (10, 2), (5, 5)])
def test_kfold_and_epoch_plans_are_bit_equal(n, k):
    a = t_cv.kfold_indices(n, k, np.random.default_rng(3))
    b = j_cv.kfold_indices(n, k, np.random.default_rng(3))
    for (ta, ea), (tb, eb) in zip(a, b, strict=True):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ea, eb)
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    for idx in (a[0][0], a[-1][1], np.arange(n)):
        for bs in (4, 32):
            pa, pb = t_dataset.epoch_plan(idx, bs, ra), j_dataset.epoch_plan(idx, bs, rb)
            for x, y in zip(pa, pb):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
            np.testing.assert_array_equal(t_dataset.epoch_plan(idx, bs)[0],
                                          j_dataset.epoch_plan(idx, bs)[0])
    assert ra.integers(1 << 30) == rb.integers(1 << 30)  # same draws consumed


def _ragged(rng, n, d, lo, hi):
    return [rng.normal(size=(int(rng.integers(lo, hi)), d)).astype(np.float32)
            for _ in range(n)]


def test_align_functions_are_bit_equal(rng):
    feats = _ragged(rng, 6, 5, 1, 30)
    for dst in (1, 4, 7, 29, 40):
        for f in feats:
            np.testing.assert_array_equal(t_align.map_feature_np(f, dst),
                                          j_align.map_feature_np(f, dst))
    np.testing.assert_array_equal(t_align.align_to_utt_np(feats),
                                  j_align.align_to_utt_np(feats))
    for s in (1, 6, 12):
        for x, y in zip(t_align.feature_scale_compress_np(feats, s),
                        j_align.feature_scale_compress_np(feats, s), strict=True):
            np.testing.assert_array_equal(x, y)
    texts, videos = _ragged(rng, 6, 3, 2, 9), _ragged(rng, 6, 4, 1, 50)
    for x, y in zip(t_align.align_to_text_np(feats, texts, videos),
                    j_align.align_to_text_np(feats, texts, videos), strict=True):
        for a, b in zip(x, y, strict=True):
            np.testing.assert_array_equal(a, b)
    for m in (None, 35):
        for a, b in zip(t_align.pad_to_maxlen_np(feats, m),
                        j_align.pad_to_maxlen_np(feats, m)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("feat_type,scale", [("utt", 1), ("frm_align", 6),
                                             ("frm_unalign", 12), ("frm_align", 1)])
def test_feature_dataset_from_raw_is_bit_equal(rng, feat_type, scale):
    n = 7
    raw = (_ragged(rng, n, 6, 20, 90), _ragged(rng, n, 5, 4, 20), _ragged(rng, n, 3, 10, 60))
    emos, vals = rng.integers(0, 6, n), rng.normal(size=n)
    a = t_dataset.FeatureDataset.from_raw([f"c{i}" for i in range(n)], emos, vals,
                                          *raw, feat_type, scale)
    b = j_dataset.FeatureDataset.from_raw([f"c{i}" for i in range(n)], emos, vals,
                                          *raw, feat_type, scale)
    for k, v in b.arrays().items():
        np.testing.assert_array_equal(a.arrays()[k], v)
        assert a.arrays()[k].dtype == v.dtype
    for k in ("audio_lens", "text_lens", "video_lens"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert (a.adim, a.tdim, a.vdim, a.names) == (b.adim, b.tdim, b.vdim, b.names)


def test_jax_written_labels_and_store_read_the_same(tmp_path, rng):
    path = str(tmp_path / "label.npz")
    j_labels.write_label_archive(path, {
        "train": {"a": {"emo": "happy", "val": 0.5}, "b": {"emo": 2, "val": ""},
                  "c": {"val": -1.5}},
        "test1": {"d": {"emo": "worried", "val": None}}})
    for split in ("train", "test1"):
        got, ref = t_labels.read_names_labels(path, split), j_labels.read_names_labels(path, split)
        assert got[0] == ref[0]
        for x, y in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    with pytest.raises(KeyError):
        t_labels.read_names_labels(path, "test2")
    # the port's archive reads the same in the JAX package
    t_labels.write_label_archive(str(tmp_path / "t.npz"), {"train": {"a": {"emo": "sad", "val": 1.0}}})
    assert j_labels.read_names_labels(str(tmp_path / "t.npz"), "train")[1].tolist() == [3]

    root = str(tmp_path / "store")
    j_store.write_feature(root, "utt", rng.normal(size=4))
    j_store.write_feature(root, "fra", rng.normal(size=(7, 4)))
    frames = tmp_path / "store" / "dir"  # OpenFace-style per-frame files
    frames.mkdir()
    for i in range(3):
        np.save(frames / f"{i:03d}.npy", rng.normal(size=(1, 4)).astype(np.float32))
    names = ["utt", "fra", "dir"]
    got, dim = t_store.read_features(root, names)
    ref, _ = j_store.read_features(root, names)
    assert dim == 4 and [g.shape for g in got] == [(1, 4), (7, 4), (3, 4)]
    for x, y in zip(got, ref, strict=True):
        np.testing.assert_array_equal(x, y)
    assert t_store.check_completeness(root, names + ["gone"]) == ["gone"]
    with pytest.raises(FileNotFoundError):
        t_store.read_one_feature(root, "gone")


@pytest.mark.parametrize("name", ["MER2023", "MER2024", "MER2025", "MER2026", "MELD",
                                  "IEMOCAPFour", "IEMOCAPSix", "CMUMOSI", "CMUMOSEI",
                                  "SIMS", "SIMSv2", "CROSSDIS", "CROSSDIM"])
def test_loader_protocols_match_jax(name):
    from mertools_tpu.core.registry import registry as j_registry
    from mertools_tpu_torch.core.registry import registry as t_registry

    a, b = Args(dataset=name), JArgs(dataset=name)
    tl, jl = t_registry.get_dataset(name)(a), j_registry.get_dataset(name)(b)
    keys = ("output_dim1", "output_dim2", "metric_name", "num_folder")
    assert [a[k] for k in keys] == [b[k] for k in keys]
    assert (tl.test_splits, tl.fixed_eval_split) == (jl.test_splits, jl.fixed_eval_split)
    assert tl.calc_results.__name__ == jl.calc_results.__name__


def test_iemocap_session_folds_match_jax():
    names = [f"Ses0{s}F_impro{i:02d}" for s in (3, 1, 5, 2, 4) for i in range(3)]
    got = t_loaders.IEMOCAPFourLoader(Args()).make_folds(names, seed=0)
    ref = j_loaders.IEMOCAPFourLoader(JArgs()).make_folds(names, seed=0)
    for (a, b), (c, d) in zip(got, ref, strict=True):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_cross_corpus_loaders_match_jax(tmp_path, rng):
    """CROSSDIS (MER2023 -> MELD: the 4 shared emotions, re-indexed) and
    CROSSDIM (CMUMOSI -> SIMS) build the same sets and folds."""
    def store(root, corpora, d=4):
        j_labels.write_label_archive(str(root / "labels.npz"), corpora)
        for corpus in corpora.values():
            for n in corpus:
                for s in ("audio-UTT", "text-UTT", "video-UTT"):
                    j_store.write_feature(str(root / "features" / s), n, rng.normal(size=d))
    emos = ["happy", "sad", "neutral", "angry", "worried", "surprise"]
    for name, corpora in {
            "mer": {"train": {f"m{i}": {"emo": emos[i % 6], "val": 0.1 * i} for i in range(24)}},
            "meld": {"test": {f"t{i}": {"emo": i % 4, "val": 0.0} for i in range(8)}},
            "cmu": {s: {f"{s}{i}": {"val": float(i - 3)} for i in range(7)}
                    for s in ("train", "val")},
            "sims": {"test": {f"s{i}": {"val": float(i % 3 - 1)} for i in range(6)}}}.items():
        (tmp_path / name).mkdir()
        store(tmp_path / name, corpora)
    for src, tgt in (("MER2023", "MELD"), ("CMUMOSI", "SIMS")):
        paths = {"MER2023": "mer", "MELD": "meld", "CMUMOSI": "cmu", "SIMS": "sims"}
        kw = dict(train_dataset=src, test_dataset=tgt, audio_feature="audio-UTT",
                  text_feature="text-UTT", video_feature="video-UTT", feat_type="utt",
                  features_root=str(tmp_path / paths[src] / "features"),
                  label_path=str(tmp_path / paths[src] / "labels.npz"),
                  test_features_root=str(tmp_path / paths[tgt] / "features"),
                  test_label_path=str(tmp_path / paths[tgt] / "labels.npz"))
        a, b = Args(kw), JArgs(kw)
        got = t_loaders.get_loader(a).load(seed=5)
        ref = j_loaders.get_loader(b).load(seed=5)
        assert a.output_dim1 == b.output_dim1 and a.metric_name == b.metric_name
        for x, y in zip(got[1], ref[1], strict=True):
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])
        sets_a = [got[0], *got[2].values()]
        sets_b = [ref[0], *ref[2].values()]
        assert list(got[2]) == list(ref[2])
        for sa, sb in zip(sets_a, sets_b, strict=True):
            assert sa.names == sb.names
            for k, v in sb.arrays().items():
                np.testing.assert_array_equal(sa.arrays()[k], v)
    with pytest.raises(SystemExit, match="must both be dimensional or both discrete"):
        t_loaders.get_loader(Args(train_dataset="CMUMOSI", test_dataset="MELD"))


def test_random_select_draws_as_the_jax_package():
    from mertools_tpu.core.config import random_select as j_random_select

    space = {"hidden_dim": [64, 128, 256], "dropout": [0.2, 0.3, 0.4, 0.5],
             "grad_clip": [-1.0], "lr": [1e-3, 1e-4], "fixed": 7}
    for seed in range(20):
        assert (random_select(space, np.random.default_rng(seed))
                == j_random_select(space, np.random.default_rng(seed)))


def test_loader_names_a7_for_top_n_and_raw_inputs(tmp_path):
    """videomae_pretrain's raw videos still exit naming ROADMAP A7b;
    e2e_model's build an ``E2EDataset`` (here of audio, the JAX loader's
    ``--e2e_nseg`` / ``--e2e_seglen`` defaults); under --fusion_topn the
    loader builds the top-N dataset and records its widths in
    ``feat_dims``."""
    from mertools_tpu_torch.io import wav as wav_io

    loader = t_loaders.MER2023Loader(Args({"model": "videomae_pretrain"}))
    with pytest.raises(SystemExit, match="ROADMAP A7b"):
        loader._build(["a"], np.zeros(1), np.zeros(1))
    wav_io.write_wav(str(tmp_path / "a.wav"), np.sin(np.arange(40000) / 7.0) * 0.3)
    kw = {"model": "e2e_model", "e2e_name": "tiny-audio", "raw_audio_root": str(tmp_path)}
    got = t_loaders.MER2023Loader(Args(kw))._build(["a"], np.zeros(1), np.zeros(1))
    ref = j_loaders.MER2023Loader(JArgs(kw))._build(["a"], np.zeros(1), np.zeros(1))
    assert got.data["audios"].shape == (1, 8, 32000)
    np.testing.assert_array_equal(got.data["audios"], ref.data["audios"])
    from mertools_tpu_torch.core.globals_mer import feature_dir_name
    from mertools_tpu_torch.data.dataset import TopNFeatureDataset

    names = TopNFeatureDataset.feature_names(2, "AVT")
    for i, n in enumerate(names):
        t_store.write_feature(str(tmp_path / feature_dir_name(n, "UTT")), "a",
                              np.full(3 + i, i, np.float32))
    args = Args(fusion_topn=2, features_root=str(tmp_path))
    ds = t_loaders.MER2023Loader(args)._build(["a"], np.zeros(1), np.zeros(1))
    assert isinstance(ds, TopNFeatureDataset)
    assert args.feat_dims == ds.feat_dims == [3 + i for i in range(6)]
