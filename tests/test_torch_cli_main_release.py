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
    (["--model=e2e_model"], "--model=e2e_model needs --e2e_name"),
    (["--model=videomae_pretrain"], "ROADMAP A7b"),
    (["--fusion_topn=2"], "--fusion_topn trains --model=attention_topn"),
])
def test_what_is_not_ported_exits_naming_its_roadmap_item(tmp_path, request, extra, match):
    """videomae_pretrain still exits naming its ROADMAP item; e2e_model
    without an encoder name exits; --fusion_topn with another model exits
    naming the model it trains; the rest of the zoo (here TFN) runs."""
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


def _tone_corpus(root, n: int = 10):
    """tests/test_e2e_model.py's tone corpus: 0.5 s wavs of 200 / 500 Hz
    (two separable classes) and a MER2025 label archive."""
    from mertools_tpu_torch.io import wav as wav_io

    (root / "audio").mkdir()
    t = np.arange(8000) / 16000.0
    corpus = {}
    for i in range(n):
        name = f"c{i:02d}"
        wav_io.write_wav(str(root / "audio" / f"{name}.wav"),
                         0.4 * np.sin(2 * np.pi * (200.0, 500.0)[i % 2] * t))
        corpus[name] = {"emo": EMOS_MER[i % 2], "val": 0.0}
    labels.write_label_archive(str(root / "labels.npz"), {"train": corpus})
    return {n: wav_io.read_wav_16k(str(root / "audio" / f"{n}.wav")) for n in corpus}


def test_e2e_savemodel_round_trips_through_extract_audio(tmp_path, capsys):
    """``--model=e2e_model --savemodel`` on a checkpoint directory of the
    chinese-hubert-large name (a narrow encoder: the directory decides the
    architecture) writes ``config.json`` + ``pytorch_model.bin`` to
    ``{save_root}/model/fold{i}_backbone``, the JAX CLI's path for the same
    flags (its run_cv saves under ``args.save_root``); ``extract_audio
    --finetuned_ckpt`` then gives the saved encoder's features, and refuses a
    checkpoint of another width or depth with the architecture message."""
    import dataclasses

    from mertools_tpu_torch.cli import extract_audio
    from mertools_tpu_torch.core.checkpoint import read_hf_weights, write_hf_checkpoint
    from mertools_tpu_torch.encoders import wav2vec2 as tw
    from mertools_tpu_torch.features.audio import AudioExtractor
    from mertools_tpu_torch.models.e2e_model import _tiny_config

    wavs = _tone_corpus(tmp_path)
    cfg = _tiny_config("audio")
    pre = tmp_path / "pretrain"
    write_hf_checkpoint(str(pre / "chinese-hubert-large"), cfg.to_config_json(),
                        tw.init_params(cfg, torch.Generator().manual_seed(0)))
    save = tmp_path / "saved"
    result = main_release.main([
        "--dataset=MER2025", "--model=e2e_model", "--e2e_name=chinese-hubert-large",
        f"--pretrain_dir={pre}", f"--raw_audio_root={tmp_path / 'audio'}", "--lr=1e-3",
        "--batch_size=4", "--epochs=2", "--seed=0", "--e2e_nseg=2", "--e2e_seglen=2000",
        "--savemodel", f"--save_root={save}", f"--features_root={tmp_path}",
        f"--label_path={tmp_path / 'labels.npz'}", "--device", "cpu"])
    assert len(result.folds) == 5 and np.isfinite(result.cv["emofscore"])
    for i in range(5):
        fold = save / "model" / f"fold{i}_backbone"
        assert sorted(os.listdir(fold)) == ["config.json", "pytorch_model.bin"]
    made = os.listdir(f"{save}-others/result")
    assert len(made) == 1 and "model:e2e_model+utt+chinese-hubert-large_" in made[0]
    assert "_e2e_backbone_params" not in np.load(
        f"{save}-others/result/{made[0]}", allow_pickle=True)["args"].item()
    fold0 = save / "model" / "fold0_backbone"
    saved = tw.load_hf_state_dict(read_hf_weights(str(fold0)))
    assert tw.Wav2Vec2Config.from_config_json(
        __import__("json").loads((fold0 / "config.json").read_text())) == cfg

    argv = ["--model_name", "chinese-hubert-large", "--pretrain_dir", str(pre),
            "--audio_dir", str(tmp_path / "audio"), "--batch_budget_sec", "1",
            "--device", "cpu"]
    extract_audio.main(argv + ["--save_dir", str(tmp_path / "ft"),
                               "--finetuned_ckpt", str(fold0)])
    assert "loaded fine-tuned backbone from" in capsys.readouterr().out
    got = {n: np.load(tmp_path / "ft" / "chinese-hubert-large-UTT" / f"{n}.npy")
           for n in wavs}
    want = AudioExtractor(cfg, saved, sample_budget=16000, device="cpu").extract(
        wavs, level="UTT")
    base = AudioExtractor(cfg, read_hf_weights(str(pre / "chinese-hubert-large")),
                          sample_budget=16000, device="cpu").extract(wavs, level="UTT")
    for n in wavs:
        assert np.abs(got[n] - want[n]).max() <= 1e-6 * np.abs(want[n]).max()
        assert np.abs(base[n] - want[n]).max() > 1e-4 * np.abs(want[n]).max()

    wide = dataclasses.replace(cfg, hidden_size=24, intermediate_size=48)
    deep = dataclasses.replace(cfg, num_hidden_layers=5)
    for other, match in ((wide, "leaf shapes do not match the selected model architecture"),
                         (deep, "checkpoint tree does not match the selected model "
                                "architecture")):
        bad = write_hf_checkpoint(str(tmp_path / f"bad{other.num_hidden_layers}"),
                                  other.to_config_json(),
                                  tw.init_params(other, torch.Generator().manual_seed(1)))
        with pytest.raises(ValueError, match=match):
            extract_audio.main(argv + ["--save_dir", str(tmp_path / "x"),
                                       "--finetuned_ckpt", bad])


def test_savemodel_on_a_fusion_model_saves_nothing(synth_store, tmp_path, capsys):
    """A model without a backbone has nothing to save (the JAX trainer's
    branch is guarded by ``"backbone" in state.params``); the CLI says so
    in one line and trains as without the flag."""
    save = tmp_path / "s"
    result = main_release.main(_flags(synth_store, save, "--savemodel", "--hidden_dim=8",
                                      "--epochs=1", "--device", "cpu"))
    assert result.test_results["test1"]["emoprobs"].shape == (12, 6)
    out = capsys.readouterr().out
    assert out.count("--savemodel: --model=attention has no fine-tuned backbone; "
                     "nothing is saved") == 1
    assert not os.path.exists(save / "model")
