"""Top-N fusion and the sweep CLI in the port, against the JAX package
on the CPU: ``TopNFeatureDataset.build`` on the same stores for each
modality subset and with an snr tag; ``main_release --fusion_topn`` end to
end and its exit without ``--model``; the sweep's argv sequence and JSON
line against JAX's sweep with ``main_release.main`` replaced by the same
scripted stub; and one real tiny sweep."""

import json
import os

import numpy as np
import pytest
import torch

from mertools_tpu.cli import main_release as j_main_release
from mertools_tpu.cli import sweep as j_sweep
from mertools_tpu.data import dataset as j_dataset
from mertools_tpu_torch.cli import main_release, sweep
from mertools_tpu_torch.core.globals_mer import EMOS_MER, feature_dir_name
from mertools_tpu_torch.data import feature_store, labels
from mertools_tpu_torch.data.dataset import TopNFeatureDataset, snr_variant
from mertools_tpu_torch.models.attention_topn import AttentionTopN
from mertools_tpu_torch.train import loop

torch.set_num_threads(1)
MODALITIES = ("AVT", "AV", "AT", "VT")


def _write_topn_stores(root, names, emos, topn: int, snr=None, seed: int = 0):
    """One UTT store an encoder of every modality's top ``topn`` (widths
    4 + the store's index), class-separable."""
    rng = np.random.default_rng(seed)
    wanted = sorted({n for m in MODALITIES for n in TopNFeatureDataset.feature_names(topn, m)})
    for k, enc in enumerate(wanted):
        d = 4 + k
        centres = rng.normal(size=(6, d)) * 3.0
        store = os.path.join(root, snr_variant(feature_dir_name(enc, "UTT"), snr))
        for n, e in zip(names, emos):
            feature_store.write_feature(store, n, centres[e] + 0.1 * rng.normal(size=d))


@pytest.mark.parametrize("modality,snr", [(m, None) for m in MODALITIES]
                         + [("AVT", "noisesnrmix")])
def test_topn_dataset_matches_jax(tmp_path, modality, snr):
    names = [f"c{i}" for i in range(5)]
    emos = np.arange(5) % 6
    _write_topn_stores(str(tmp_path), names, emos, 3, snr)
    got = TopNFeatureDataset.build(names, emos, emos / 6.0, str(tmp_path), 3, modality, snr)
    ref = j_dataset.TopNFeatureDataset.build(names, emos, emos / 6.0, str(tmp_path), 3,
                                             modality, snr)
    assert got.feat_dims == ref.feat_dims and len(got.feats) == 9
    assert got.arrays().keys() == ref.arrays().keys()
    for k, v in ref.arrays().items():
        np.testing.assert_array_equal(got.arrays()[k], v)
    if modality == "AT":  # the text ranking fills two of the three slots
        names_at = got.feature_names(3, "AT")
        assert names_at[3:6] == names_at[6:]


@pytest.fixture(scope="module")
def topn_store(tmp_path_factory):
    """A MER2023-layout top-N store (top 2 of every ranking): 40 train
    clips, 12 in test1."""
    root = tmp_path_factory.mktemp("topn")
    rng = np.random.default_rng(1)
    corpora, names, emos = {}, [], []
    for split, n in (("train", 40), ("test1", 12)):
        e = rng.integers(0, 6, n)
        ns = [f"{split}_{i:03d}" for i in range(n)]
        corpora[split] = {a: {"emo": EMOS_MER[b], "val": float((b - 3) / 6)}
                          for a, b in zip(ns, e)}
        names += ns
        emos += list(e)
    _write_topn_stores(str(root / "features"), names, emos, 2)
    labels.write_label_archive(str(root / "label.npz"), corpora)
    return root


def _topn_flags(root, save_root, *extra):
    return ["--dataset=MER2023", "--fusion_topn=2", "--fusion_modality=AVT",
            "--feat_type=utt", "--lr=1e-2", "--batch_size=8", "--epochs=2",
            "--seed=0", "--dropout=0", "--hidden_dim=16",
            f"--features_root={root / 'features'}", f"--label_path={root / 'label.npz'}",
            f"--save_root={save_root}", *extra]


def test_main_release_fusion_topn_runs_on_the_cpu(topn_store, tmp_path, monkeypatch):
    built = []
    init_model = loop.init_model

    def record(args, sample_batch, generator):
        built.append(init_model(args, sample_batch, generator))
        return built[-1]

    monkeypatch.setattr(loop, "init_model", record)
    res = main_release.main(_topn_flags(topn_store, tmp_path / "s", "--model=attention_topn",
                                        "--device", "cpu"))
    assert len(built) == 5 and isinstance(built[0], AttentionTopN)
    assert [getattr(built[0], f"encoder{i}").dense_1.in_features for i in range(6)] == \
        TopNFeatureDataset.build(["train_000"], [0], [0.0], str(topn_store / "features"),
                                 2).feat_dims
    assert res.cv["emofscore"] > 0.5
    assert res.test_results["test1"]["emoprobs"].shape == (12, 6)
    made = os.listdir(tmp_path / "s-others" / "result")
    assert sorted(f.split("_")[0] for f in made) == ["cv", "test1"]
    assert all("_fusiontopn:2_modality:AVT" in f for f in made)


def test_fusion_topn_without_model_exits_with_its_message(topn_store, tmp_path):
    """The JAX CLI raises KeyError: None here (it reads the tune space of
    --model before defaulting it); the port asks for the model."""
    with pytest.raises(SystemExit, match="--fusion_topn trains --model=attention_topn"):
        main_release.main(_topn_flags(topn_store, tmp_path / "s", "--device", "cpu"))
    with pytest.raises(KeyError):
        j_main_release.main(_topn_flags(topn_store, tmp_path / "j"))


class _Result:
    def __init__(self, cv, chosen_hp):
        self.cv, self.chosen_hp = cv, chosen_hp


def _scripted(calls: list):
    """A main_release stand-in: records each argv and answers with a
    scripted score per seed and the hyperparameters its seed would draw."""
    def run(argv):
        calls.append(list(argv))
        seed = int(argv[-1].split("=")[1])
        return _Result({"emoval": 0.1 * ((seed * 7) % 5), "emofscore": 0.5},
                       {"hidden_dim": 64 << (seed % 3), "lr": 1e-3})
    return run


def test_sweep_matches_the_jax_sweep(monkeypatch, capsys):
    argv = ["--n_search=4", "--n_repeat=3", "--base_seed=5", "--", "--model=attention",
            "--dataset=MER2023"]
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(j_main_release, "main", _scripted(calls["jax"]))
    monkeypatch.setattr(main_release, "main", _scripted(calls["port"]))
    j_sweep.main(argv)
    ref = capsys.readouterr().out.strip().splitlines()
    sweep.main(argv)
    got = capsys.readouterr().out.strip().splitlines()
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 7
    assert got == ref
    best = max(range(5, 9), key=lambda s: 0.1 * ((s * 7) % 5))
    hp = [f"--hidden_dim={64 << (best % 3)}", "--lr=0.001"]
    assert all(c[2:4] == hp for c in calls["port"][4:])
    assert json.loads(got[-1])["n_repeat"] == 3


def test_a_real_tiny_sweep_runs_on_the_cpu(topn_store, tmp_path, capsys):
    sweep.main(["--n_search=2", "--n_repeat=2", "--",
                *_topn_flags(topn_store, tmp_path / "s", "--model=attention_topn",
                             "--device", "cpu")])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line["n_search"] == 2 and line["n_repeat"] == 2
    assert 0.0 <= line["repeat_mean"] <= 2.0 and np.isfinite(line["best_search"])
    assert sum(o.startswith("repeat ") for o in out) == 2
