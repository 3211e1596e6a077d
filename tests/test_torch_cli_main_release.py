"""The port's main_release CLI end to end on a synthetic MER2023-layout
store (as tests/test_cli_main_release.py drives the JAX CLI): the same
flags, hyperparameter draw, folds and artifacts as the JAX CLI, with each
fold started from JAX's initial weights through the trainer's
``init_model`` seam; and the exits that name what waits on the ROADMAP."""

import os
import re

import jax
import numpy as np
import pytest
import torch

from mertools_tpu.cli import main_release as j_main_release
from mertools_tpu.core.config import Args as JArgs
from mertools_tpu.models import get_model as j_get_model
from mertools_tpu_torch.cli import main_release
from mertools_tpu_torch.core.globals_mer import EMOS_MER
from mertools_tpu_torch.data import feature_store, labels
from mertools_tpu_torch.models import get_model
from mertools_tpu_torch.models.base import state_dict_from_flax
from mertools_tpu_torch.train import loop

torch.set_num_threads(1)
STORES = (("audio-UTT", 8), ("text-UTT", 10), ("video-UTT", 6))


@pytest.fixture(scope="module")
def synth_store(tmp_path_factory):
    """A tiny MER2023-layout dataset on disk: 40 train clips, 12 in test1."""
    root = tmp_path_factory.mktemp("mer2023")
    centers = np.random.default_rng(42)
    centers = {s: centers.normal(size=(6, d)) * 3.0 for s, d in STORES}

    def gen(split, n, seed):
        rng = np.random.default_rng(seed)
        corpus = {}
        for i in range(n):
            name = f"{split}_{i:04d}"
            e = int(rng.integers(0, 6))
            corpus[name] = {"emo": EMOS_MER[e], "val": float((e - 3) / 6)}
            for store, d in STORES:
                feat = (centers[store][e] + 0.1 * rng.normal(size=d)).astype(np.float32)
                feature_store.write_feature(str(root / "features" / store), name, feat)
        return corpus

    labels.write_label_archive(str(root / "label-6way.npz"),
                               {"train": gen("train", 40, 1), "test1": gen("test1", 12, 2)})
    return root


def _flags(root, save_root, *extra):
    return ["--dataset=MER2023", "--audio_feature=audio-UTT", "--text_feature=text-UTT",
            "--video_feature=video-UTT", "--feat_type=utt", "--model=attention",
            "--lr=1e-2", "--batch_size=8", "--epochs=3", "--seed=0", "--dropout=0",
            f"--save_root={save_root}", f"--features_root={root / 'features'}",
            f"--label_path={root / 'label-6way.npz'}", *extra]


def _artifacts(save_root):
    res = os.path.join(f"{save_root}-trimodal", "result")
    return {re.sub(r"_[0-9.]+\.npz$", "", f): np.load(os.path.join(res, f), allow_pickle=True)
            for f in os.listdir(res)}


def test_main_release_matches_the_jax_cli(synth_store, tmp_path, monkeypatch):
    """Same random hyperparameters, folds and batch orders from one --seed;
    each fold starts from JAX's initial weights, so the artifact names agree
    to the stamp (metrics to 4 decimals included) and the fold-averaged
    test1 logits within 1e-4 of max|jax|. Width 16: at 256, elements whose
    gradient is within fp32 rounding of 0 (|g| ~ Adam's eps) take Adam's
    first updates in whichever direction each package's rounding gives
    them, and three epochs grow that past the 4 decimals of the valence
    MSE in the artifact names."""
    flags = _flags(synth_store, tmp_path / "jax", "--hidden_dim=16")
    ref = j_main_release.main(flags)
    folds = []

    def init_from_jax(args, sample_batch, generator):
        _, key = jax.random.split(jax.random.PRNGKey(0 * 1000 + len(folds)))
        folds.append(len(folds))
        params = j_get_model(JArgs(args)).init({"params": key}, sample_batch,
                                               train=False)["params"]
        dims = tuple(sample_batch[k].shape[-1] for k in ("audios", "texts", "videos"))
        model = get_model(args, dims)
        model.load_state_dict(state_dict_from_flax(params))
        return model

    monkeypatch.setattr(loop, "init_model", init_from_jax)
    got = main_release.main(_flags(synth_store, tmp_path / "port", "--hidden_dim=16",
                                   "--device", "cpu"))
    assert folds == [0, 1, 2, 3, 4]
    assert got.cv["emofscore"] > 0.5  # separable data
    assert got.chosen_hp == ref.chosen_hp and got.cv_str == ref.cv_str
    assert got.best_epochs == ref.best_epochs
    ours, theirs = _artifacts(tmp_path / "port"), _artifacts(tmp_path / "jax")
    assert sorted(ours) == sorted(theirs)
    assert sorted(n.split("_features:")[0] for n in ours) == ["cv", "test1"]
    name = next(n for n in ours if n.startswith("test1_"))
    a, b = ours[name]["emoprobs"], theirs[name]["emoprobs"]
    assert a.shape == (12, 6)
    assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
    np.testing.assert_array_equal(ours[name]["emolabels"], theirs[name]["emolabels"])


def test_main_release_with_random_hyperparameters(synth_store, tmp_path):
    """The random search on its own (dropout drawn from model_tune.yaml),
    as tests/test_cli_main_release.py runs the JAX CLI."""
    flags = [f for f in _flags(synth_store, tmp_path / "r") if f != "--dropout=0"]
    result = main_release.main(flags + ["--device", "cpu", "--lr=1e-3", "--epochs=5"])
    assert result.cv["emofscore"] > 0.5
    assert result.chosen_hp["dropout"] in (0.2, 0.3, 0.4, 0.5)
    assert result.test_results["test1"]["emoprobs"].shape == (12, 6)


@pytest.mark.parametrize("extra,match", [
    (["--model=tfn"], None),  # ported: trains
    (["--model=e2e_model"], "e2e fine-tuning .*ROADMAP A7"),
    (["--model=videomae_pretrain"], "ROADMAP A7"),
    (["--fusion_topn=2"], "--fusion_topn trains --model=attention_topn"),
    (["--savemodel"], "ROADMAP A7, A17"),
])
def test_what_is_not_ported_exits_naming_its_roadmap_item(tmp_path, request, extra, match):
    """The raw-input models and --savemodel still exit naming their ROADMAP
    item; --fusion_topn with another model exits naming the model it
    trains; the rest of the zoo (here TFN) runs."""
    root = request.getfixturevalue("synth_store") if match is None else tmp_path
    flags = [f for f in _flags(root, tmp_path / "x") if f != "--model=attention"]
    if not any(e.startswith("--model") for e in extra):
        flags.append("--model=attention")
    if match is None:
        result = main_release.main(flags + extra + ["--hidden_dim=8", "--epochs=1",
                                                    "--device", "cpu"])
        assert result.test_results["test1"]["emoprobs"].shape == (12, 6)
        return
    with pytest.raises(SystemExit, match=match):
        main_release.main(flags + extra + ["--device", "cpu"])


def test_main_release_defaults_to_the_card(synth_store, tmp_path):
    """No --device: cuda, which raises here before any data is read."""
    for extra in ([], ["--device", "cuda", "--gpu", "0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main_release.main(_flags(synth_store, tmp_path / "c") + extra)
    assert not os.path.exists(f"{tmp_path / 'c'}-trimodal")
