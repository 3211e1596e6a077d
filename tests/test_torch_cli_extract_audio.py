"""The port's extract_audio CLI, mirroring tests/test_cli_extract_audio.py:
prefetch-chunked loop, idempotent skip, int16 wire, --dataset registry
resolution, --finetuned_ckpt and --compute_dtype int8, on tiny random
weights with --device cpu; and the package's promise never to import JAX or
the JAX package (chip_smoke.py's too)."""

import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from mertools_tpu_torch.cli.extract_audio import main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_wav(path, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=n) * 3000).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(w.tobytes())


def test_extract_audio_cli_end_to_end(tmp_path, monkeypatch):
    wav_dir = tmp_path / "audio"
    wav_dir.mkdir()
    for i, n in enumerate((1600, 2400, 800)):
        _write_wav(wav_dir / f"clip{i}.wav", n, i)

    yaml = tmp_path / "paths.yaml"
    yaml.write_text("datasets:\n  TEST:\n    root: %s\n" % tmp_path)
    monkeypatch.setenv("MERTOOLS_TPU_CONFIG", str(yaml))

    # --dataset resolves audio_dir/save_dir from the registry
    main(["--model_name", "chinese-hubert-tiny", "--dataset", "TEST",
          "--random_init", "--encoder_size", "tiny", "--device", "cpu",
          "--feature_level", "UTTERANCE", "--transfer_dtype", "int16",
          "--batch_budget_sec", "2"])

    out_dir = tmp_path / "features" / "chinese-hubert-tiny-UTT"
    files = sorted(os.listdir(out_dir))
    assert files == ["clip0.npy", "clip1.npy", "clip2.npy"]
    first = np.load(out_dir / "clip0.npy")
    assert first.shape == (64,) and np.isfinite(first).all()

    # idempotent re-run: existing outputs are skipped, content unchanged
    mtimes = {f: os.path.getmtime(out_dir / f) for f in files}
    main(["--model_name", "chinese-hubert-tiny", "--dataset", "TEST",
          "--random_init", "--encoder_size", "tiny", "--device", "cpu",
          "--feature_level", "UTTERANCE"])
    for f in files:
        assert os.path.getmtime(out_dir / f) == mtimes[f]

    # FRAME level on the f32 wire: (frames, hidden) per clip
    main(["--model_name", "chinese-hubert-tiny", "--audio_dir", str(wav_dir),
          "--save_dir", str(tmp_path / "features"), "--random_init",
          "--encoder_size", "tiny", "--device", "cpu",
          "--feature_level", "FRAME"])
    fra = np.load(tmp_path / "features" / "chinese-hubert-tiny-FRA" / "clip1.npy")
    assert fra.shape == (((2400 - 10) // 5 + 1 - 3) // 2 + 1, 64)


@pytest.mark.parametrize("argv,match", [
    (["--model_name", "vggish"], "A9"),
    (["--model_name", "wav2vec-large"], "wav2vec-1.0"),
    (["--model_name", "emotion2vec_base"], "A9"),
    (["--model_name", "imagebind_huge"], "A9"),
    (["--model_name", "whisper-large-v2", "--finetuned_ckpt", "x"],
     "no Whisper encoder"),
])
def test_unported_branches_exit_naming_roadmap(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        main(argv + ["--audio_dir", str(tmp_path), "--save_dir", str(tmp_path),
                     "--random_init", "--device", "cpu"])


@pytest.mark.parametrize("compute_dtype", ["f32", "int8"])
def test_finetuned_ckpt_replaces_the_weights(tmp_path, compute_dtype):
    """``--finetuned_ckpt DIR`` (``config.json`` + ``pytorch_model.bin``,
    what ``main_release --savemodel`` writes) replaces the tiny random
    encoder's weights: the UTT files equal an extractor's on DIR's weights,
    in fp32 and in the int8 mode; DIR of another width is refused with the
    JAX CLI's architecture message."""
    import dataclasses

    from mertools_tpu_torch.cli.extract_audio import load_encoder
    from mertools_tpu_torch.core.checkpoint import write_hf_checkpoint
    from mertools_tpu_torch.encoders.wav2vec2 import init_params
    from mertools_tpu_torch.features.audio import AudioExtractor
    from mertools_tpu_torch.io import wav as wav_io

    wav_dir = tmp_path / "audio"
    wav_dir.mkdir()
    for i, n in enumerate((1600, 2400)):
        _write_wav(wav_dir / f"clip{i}.wav", n, i)
    cfg, _ = load_encoder("m", None, True, "tiny")
    ft = init_params(cfg, torch.Generator().manual_seed(7))
    ckpt = write_hf_checkpoint(str(tmp_path / "fold0_backbone"), cfg.to_config_json(), ft)
    mode = [] if compute_dtype == "f32" else ["--compute_dtype", compute_dtype]
    argv = ["--model_name", "chinese-hubert-tiny", "--audio_dir", str(wav_dir),
            "--random_init", "--encoder_size", "tiny", "--device", "cpu",
            "--batch_budget_sec", "1", *mode]
    main(argv + ["--save_dir", str(tmp_path / "out"), "--finetuned_ckpt", ckpt])
    wavs = {f"clip{i}": wav_io.read_wav_16k(str(wav_dir / f"clip{i}.wav")) for i in range(2)}
    want = AudioExtractor(cfg, ft, sample_budget=16000, device="cpu",
                          compute_dtype=None if compute_dtype == "f32" else compute_dtype
                          ).extract(wavs, level="UTT")
    for name, w in want.items():
        got = np.load(tmp_path / "out" / "chinese-hubert-tiny-UTT" / f"{name}.npy")
        np.testing.assert_array_equal(got, w)
    narrow = dataclasses.replace(cfg, hidden_size=32)
    bad = write_hf_checkpoint(str(tmp_path / "narrow"), narrow.to_config_json(),
                              init_params(narrow, torch.Generator().manual_seed(7)))
    with pytest.raises(ValueError, match="leaf shapes do not match the selected model "
                                         "architecture"):
        main(argv + ["--save_dir", str(tmp_path / "bad"), "--finetuned_ckpt", bad])


def test_extract_audio_cli_whisper(tmp_path, capsys):
    """The Whisper branch: the JAX CLI's tiny seeded config, (64,) UTT files
    that agree with a library call on the same weights, the compute_dtype
    notice, and the idempotent skip on a re-run."""
    from mertools_tpu_torch.cli.extract_audio import load_whisper
    from mertools_tpu_torch.features.audio import WhisperAudioExtractor

    wav_dir = tmp_path / "audio"
    wav_dir.mkdir()
    for i, n in enumerate((16000, 24000)):
        _write_wav(wav_dir / f"clip{i}.wav", n, i)
    argv = ["--model_name", "whisper-large-v2", "--audio_dir", str(wav_dir),
            "--save_dir", str(tmp_path / "features"), "--random_init",
            "--device", "cpu", "--transfer_dtype", "int16"]
    main(argv + ["--compute_dtype", "bf16"])
    assert "ignored" in capsys.readouterr().out
    out_dir = tmp_path / "features" / "whisper-large-v2-UTT"
    files = sorted(os.listdir(out_dir))
    assert files == ["clip0.npy", "clip1.npy"]
    feats = {f[:-4]: np.load(out_dir / f) for f in files}

    from mertools_tpu.io import wav as wav_io
    cfg, params = load_whisper("whisper-large-v2", None, True)
    ref = WhisperAudioExtractor(cfg, params, device="cpu").extract(
        {f[:-4]: wav_io.read_wav_16k(str(wav_dir / f"{f[:-4]}.wav"))
         for f in files}, "UTT")
    for n, f in feats.items():
        assert f.shape == (64,) and np.isfinite(f).all()
        assert np.abs(f - ref[n]).max() <= 1e-5, n

    mtimes = {f: os.path.getmtime(out_dir / f) for f in files}
    main(argv)
    for f in files:
        assert os.path.getmtime(out_dir / f) == mtimes[f]


def test_loaders_read_raw_checkpoint_directories(tmp_path):
    """--pretrain_dir without transformers: the config.json and weights of
    a save_pretrained HubertForCTC (its body under ``hubert.``) and
    WhisperForConditionalGeneration (under ``model.``) give the configs and
    state dicts transformers' own loaded models give."""
    import dataclasses

    import transformers as tr

    from mertools_tpu_torch.cli.extract_audio import load_encoder, load_whisper
    from mertools_tpu_torch.encoders import wav2vec2 as tw
    from mertools_tpu_torch.encoders import whisper as tws

    torch.manual_seed(0)
    hub = tr.HubertForCTC(tr.HubertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=48, conv_dim=(16, 16), conv_kernel=(10, 3),
        conv_stride=(5, 2), num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=2, vocab_size=12))
    hub.save_pretrained(str(tmp_path / "hubert-tiny"))
    whi = tr.WhisperForConditionalGeneration(tr.WhisperConfig(
        d_model=32, encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=48, decoder_ffn_dim=48, vocab_size=64,
        max_source_positions=1500, max_target_positions=32,
        decoder_start_token_id=50, eos_token_id=51, pad_token_id=51))
    whi.save_pretrained(str(tmp_path / "whisper-tiny"))

    for (cfg, sd), (want_cfg, want_sd) in (
            (load_encoder("hubert-tiny", str(tmp_path), False),
             (tw.Wav2Vec2Config.from_hf(hub.config),
              tw.load_hf_state_dict(hub.hubert.state_dict()))),
            (load_whisper("whisper-tiny", str(tmp_path), False),
             (tws.WhisperConfig.from_hf(whi.config),
              tws.load_hf_state_dict(whi.model.state_dict())))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
        assert sorted(sd) == sorted(want_sd)
        for k in want_sd:
            assert torch.equal(sd[k], want_sd[k]), k

    # a config.json without the keys whose class default differs from the
    # port's own fallback reads as transformers reads it ("group" norm)
    import json

    cfg_path = tmp_path / "hubert-tiny" / "config.json"
    raw = json.loads(cfg_path.read_text())
    for key in ("feat_extract_norm", "do_stable_layer_norm", "conv_bias"):
        del raw[key]
    cfg_path.write_text(json.dumps(raw))
    cfg, _ = load_encoder("hubert-tiny", str(tmp_path), False)
    want = tw.Wav2Vec2Config.from_hf(tr.AutoConfig.from_pretrained(tmp_path / "hubert-tiny"))
    assert cfg.feat_extract_norm == "group"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)


def test_dataset_missing_from_registry_exits(tmp_path, monkeypatch):
    monkeypatch.delenv("MERTOOLS_TPU_CONFIG", raising=False)
    with pytest.raises(SystemExit, match="not in the path registry"):
        main(["--model_name", "chinese-hubert-tiny", "--dataset", "NOPE",
              "--random_init", "--device", "cpu"])


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mertools_tpu")
# the generation and serving slice's modules, walked like every other
# modules the walk must find by name: the serving slice's and the e2e slice's
SERVING = tuple(f"mertools_tpu_torch.{m}" for m in (
    "ops.quant", "mllm.generate", "mllm.beam", "mllm.serve", "mllm.chat",
    "mllm.convert_affectgpt", "io.xlsx", "ops.ov_metrics", "cli.inference_mllm",
    "cli.evaluation", "cli.main_ov", "cli.parity_check", "cli.translate",
    "cli.ovlabel_extraction", "models.e2e_model", "data.e2e_dataset", "core.trees",
    "ops.align"))


def test_port_never_imports_jax():
    """Import every module of the package (pkgutil.walk_packages) in a fresh
    interpreter, since the test process itself imports JAX
    (tests/conftest.py), and find no JAX-family module and no module of the
    JAX package in sys.modules."""
    code = ("import importlib, pkgutil, sys, mertools_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "pkg.__name__ + '.')]\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            f"missing = sorted(set({SERVING!r}) - set(names))\n"
            "assert not missing, missing\n"
            "assert not bad, bad\n"
            "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 30   # every module was walked


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """chip_smoke.py's imports, read with ast (it may import the port)."""
    import ast

    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert "mertools_tpu_torch" in {n.split(".")[0] for n in names}
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_wav_reader_matches_the_jax_package(tmp_path):
    """The port's copy of io/wav.py reads and resamples a written WAV to the
    same samples as the JAX package's module."""
    from mertools_tpu.io import wav as jwav
    from mertools_tpu_torch.io import wav as twav

    rng = np.random.default_rng(4)
    pcm = (rng.normal(size=(3000, 2)) * 3000).astype(np.int16)   # stereo
    path = tmp_path / "stereo_22k.wav"
    with wave.open(str(path), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(22050)
        f.writeframes(pcm.tobytes())
    assert twav.have_native() == jwav.have_native()
    got, sr = twav.read_wav(str(path))
    want, sr_j = jwav.read_wav(str(path))
    assert sr == sr_j == 22050
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twav.read_wav_16k(str(path)),
                                  jwav.read_wav_16k(str(path)))
