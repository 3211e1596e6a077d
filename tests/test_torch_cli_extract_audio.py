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
          "--feature_level", "FRAME", "--batch_budget_sec", "2"])
    fra = np.load(tmp_path / "features" / "chinese-hubert-tiny-FRA" / "clip1.npy")
    assert fra.shape == (((2400 - 10) // 5 + 1 - 3) // 2 + 1, 64)


@pytest.mark.parametrize("argv,match", [
    (["--model_name", "whisper-large-v2", "--finetuned_ckpt", "x"],
     "no Whisper encoder"),
])
def test_unported_branches_exit_naming_roadmap(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        main(argv + ["--audio_dir", str(tmp_path), "--save_dir", str(tmp_path),
                     "--random_init", "--device", "cpu"])


@pytest.mark.parametrize("model,family", [
    ("vggish", "vggish"), ("wav2vec-large", "wav2vec1"),
    ("emotion2vec_base", "emotion2vec"), ("imagebind_huge", "imagebind")])
def test_finetuned_ckpt_exits_for_the_audio_zoo(tmp_path, model, family):
    """``--finetuned_ckpt`` reads a fine-tuned wav2vec2-family backbone, so
    the zoo's families refuse it, as Whisper does."""
    with pytest.raises(SystemExit, match=f"fine-tunes no {family} encoder"):
        main(["--model_name", model, "--finetuned_ckpt", "x", "--audio_dir", str(tmp_path),
              "--save_dir", str(tmp_path), "--random_init", "--device", "cpu"])


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


def _zoo_wavs(tmp_path, lengths=(6000, 13000)):
    """PCM16 wavs under ``tmp_path/audio`` and the samples both packages'
    extractors read from them."""
    from mertools_tpu_torch.io import wav as wav_io

    wav_dir = tmp_path / "audio"
    wav_dir.mkdir()
    for i, n in enumerate(lengths):
        _write_wav(wav_dir / f"clip{i}.wav", n, 20 + i)
    return wav_dir, {f"clip{i}": wav_io.read_wav_16k(str(wav_dir / f"clip{i}.wav"))
                     for i in range(len(lengths))}


def _held_to(store, want: dict, tol=2e-4):
    """Each clip's file in ``store`` against ``want`` (the JAX extractor's
    features on the same weights): max |port - JAX| <= tol * max |JAX|."""
    assert sorted(os.listdir(store)) == sorted(f"{n}.npy" for n in want)
    for n, w in want.items():
        got = np.load(store / f"{n}.npy")
        assert got.shape == w.shape, (n, got.shape, w.shape)
        assert np.abs(got - w).max() <= tol * np.abs(w).max(), n


def test_extract_audio_cli_vggish_on_a_torchvggish_checkpoint(tmp_path):
    """A torchvggish state dict (``vggish.pt``, one key VGGish does not use)
    gives FRA stores equal to the JAX extractor's on the same weights."""
    from mertools_tpu.encoders.audio_zoo import vggish_from_torch
    from mertools_tpu.features.audio import VGGishExtractor
    from mertools_tpu_torch.encoders.audio_zoo import vggish_init_params

    wav_dir, wavs = _zoo_wavs(tmp_path)
    sd = vggish_init_params(torch.Generator().manual_seed(1))
    torch.save({**sd, "pproc._pca_means": torch.zeros(128, 1)}, tmp_path / "vggish.pt")
    main(["--model_name", "vggish", "--pretrain_dir", str(tmp_path), "--audio_dir",
          str(wav_dir), "--save_dir", str(tmp_path / "f"), "--feature_level", "FRAME",
          "--device", "cpu"])
    want = VGGishExtractor(vggish_from_torch(sd)).extract(wavs, "FRA")
    assert [want[n].shape for n in wavs] == [(1, 128), (1, 128)]
    _held_to(tmp_path / "f" / "vggish-FRA", want)


def test_extract_audio_cli_wav2vec1_writes_both_stores_and_resumes_on_both(tmp_path):
    """A fairseq ``.pt`` (pickled args beside ``model``) at the published
    width: the z and c UTT stores equal the JAX extractor's; a clip whose c
    file is missing runs again, the other is skipped."""
    import argparse

    from mertools_tpu.encoders.audio_zoo import wav2vec1_from_fairseq
    from mertools_tpu.features.audio import Wav2Vec1Extractor
    from mertools_tpu_torch.encoders.audio_zoo import Wav2Vec1Config, wav2vec1_init_params

    wav_dir, wavs = _zoo_wavs(tmp_path)
    sd = wav2vec1_init_params(Wav2Vec1Config(), torch.Generator().manual_seed(2))
    torch.save({"args": argparse.Namespace(arch="wav2vec"), "model": sd},
               tmp_path / "wav2vec-large.pt")
    argv = ["--model_name", "wav2vec-large", "--pretrain_dir", str(tmp_path),
            "--audio_dir", str(wav_dir), "--save_dir", str(tmp_path / "f"), "--device", "cpu"]
    main(argv)
    zs, cs = Wav2Vec1Extractor(wav2vec1_from_fairseq(sd)).extract_zc(wavs, "UTT")
    z_dir, c_dir = tmp_path / "f" / "wav2vec-large-z-UTT", tmp_path / "f" / "wav2vec-large-c-UTT"
    _held_to(z_dir, zs)
    _held_to(c_dir, cs)
    os.remove(c_dir / "clip0.npy")
    stamp = {d / f"clip{i}.npy": os.stat(d / f"clip{i}.npy").st_mtime_ns
             for d in (z_dir, c_dir) for i in (0, 1) if (d / f"clip{i}.npy").exists()}
    main(argv)
    assert (c_dir / "clip0.npy").exists()
    assert os.stat(z_dir / "clip0.npy").st_mtime_ns != stamp[z_dir / "clip0.npy"]
    for d in (z_dir, c_dir):
        assert os.stat(d / "clip1.npy").st_mtime_ns == stamp[d / "clip1.npy"]
    _held_to(c_dir, cs)


def test_extract_audio_cli_emotion2vec_on_a_funasr_checkpoint(tmp_path):
    """A funasr ``.pt`` (``model`` with ``_ema`` and decoder keys, pickled
    config beside it) read by both packages' loaders, which infer the same
    config (12 heads, the base strides): FRA stores equal JAX's."""
    from mertools_tpu.encoders.emotion2vec import load_funasr_checkpoint
    from mertools_tpu.features.audio import Emotion2VecExtractor
    from mertools_tpu_torch.encoders import emotion2vec as te

    wav_dir, wavs = _zoo_wavs(tmp_path)
    # the base model's seven convs (320x down), 16 channels, 48 wide
    cfg = te.Emotion2VecConfig(conv_layers=tuple((16, k, s) for _, k, s in te.CONV_LAYERS_BASE),
                               hidden_size=48, prenet_depth=1, depth=1, num_heads=12,
                               conv_pos_depth=2, conv_pos_width=10, conv_pos_groups=4)
    sd = te.init_params(cfg, torch.Generator().manual_seed(3))
    extra = {"_ema.blocks.0.norm1.weight": torch.ones(48),
             "modality_encoders.AUDIO.decoder.proj.weight": torch.ones(4, 48)}
    path = tmp_path / "emotion2vec_base.pt"
    torch.save({"cfg": {"model": {"depth": 1}}, "model": {**sd, **extra}}, path)
    main(["--model_name", "emotion2vec_base", "--pretrain_dir", str(tmp_path),
          "--audio_dir", str(wav_dir), "--save_dir", str(tmp_path / "f"),
          "--feature_level", "FRAME", "--device", "cpu"])
    jcfg, params = load_funasr_checkpoint(str(path))
    assert te.load_funasr_checkpoint(str(path))[0] == cfg and jcfg.num_heads == 12
    _held_to(tmp_path / "f" / "emotion2vec_base-FRA",
             Emotion2VecExtractor(params, jcfg).extract(wavs, "FRA"))


def test_extract_audio_cli_imagebind_on_a_checkpoint_audio_subtree(tmp_path, monkeypatch):
    """An ``imagebind_huge.pth``-layout state dict (other modalities and the
    postprocessor beside the audio subtree) gives UTT stores equal to JAX's
    on the same weights. Both loaders fix the huge config; the port's is
    narrowed here to 16 wide and 2 blocks (the card runs the huge one)."""
    from mertools_tpu.encoders import imagebind as ji
    from mertools_tpu.features.audio import ImageBindAudioExtractor
    from mertools_tpu_torch.encoders import imagebind as ti

    tiny = dict(embed_dim=16, num_blocks=2, num_heads=4, out_embed_dim=24)
    cls = ti.ImageBindAudioConfig
    monkeypatch.setattr(ti, "ImageBindAudioConfig", lambda: cls(**tiny))
    wav_dir, wavs = _zoo_wavs(tmp_path, (11000, 50001))
    sd = ti.init_params(cls(**tiny), torch.Generator().manual_seed(4))
    torch.save({**sd, "modality_trunks.vision.blocks.0.attn.bias_k": torch.zeros(1, 1, 16),
                "modality_postprocessors.audio.1.log_logit_scale": torch.tensor(3.0)},
               tmp_path / "imagebind_huge.pth")
    main(["--model_name", "imagebind_huge", "--pretrain_dir", str(tmp_path),
          "--audio_dir", str(wav_dir), "--save_dir", str(tmp_path / "f"), "--device", "cpu"])
    jcfg = ji.ImageBindAudioConfig(**tiny)
    # the JAX sampler raises on a 50,001-sample clip (ROADMAP C), so JAX
    # extracts the 11,000-sample one; the other is held to the port's
    # extractor on the same weights
    want = ImageBindAudioExtractor(jcfg, ji.convert_torch_state(jcfg, sd)).extract(
        {"clip0": wavs["clip0"]}, "UTT")
    from mertools_tpu_torch.features.audio import ImageBindAudioExtractor as TEx
    want["clip1"] = TEx(cls(**tiny), sd, device="cpu").extract(
        {"clip1": wavs["clip1"]}, "UTT")["clip1"]
    _held_to(tmp_path / "f" / "imagebind_huge-UTT", want)


@pytest.mark.parametrize("model,stores,dim", [
    ("vggish", ("vggish",), 128), ("wav2vec-large", ("wav2vec-large-z", "wav2vec-large-c"), 32),
    ("emotion2vec_base", ("emotion2vec_base",), 32), ("imagebind_huge", ("imagebind_huge",), 48)])
def test_extract_audio_cli_zoo_random_init(tmp_path, capsys, model, stores, dim):
    """``--random_init``: the JAX CLI's sizes (VGGish whole; wav2vec 1.0,
    emotion2vec and ImageBind tiny) with seeded weights, finite UTT files;
    ``--compute_dtype`` and ``--transfer_dtype int16`` are ignored with a
    notice."""
    wav_dir, wavs = _zoo_wavs(tmp_path)
    main(["--model_name", model, "--audio_dir", str(wav_dir), "--save_dir",
          str(tmp_path / "f"), "--random_init", "--device", "cpu",
          "--compute_dtype", "bf16", "--transfer_dtype", "int16"])
    assert capsys.readouterr().out.count("is ignored") == 2
    for store in stores:
        for n in wavs:
            f = np.load(tmp_path / "f" / f"{store}-UTT" / f"{n}.npy")
            assert f.shape == (dim,) and np.isfinite(f).all()


def test_dataset_missing_from_registry_exits(tmp_path, monkeypatch):
    monkeypatch.delenv("MERTOOLS_TPU_CONFIG", raising=False)
    with pytest.raises(SystemExit, match="not in the path registry"):
        main(["--model_name", "chinese-hubert-tiny", "--dataset", "NOPE",
              "--random_init", "--device", "cpu"])


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mertools_tpu")
# modules the walk must find by name: the serving, e2e, audio-zoo and
# handcrafted slices'
SERVING = tuple(f"mertools_tpu_torch.{m}" for m in (
    "ops.quant", "mllm.generate", "mllm.beam", "mllm.serve", "mllm.chat",
    "mllm.convert_affectgpt", "io.xlsx", "ops.ov_metrics", "cli.inference_mllm",
    "cli.evaluation", "cli.main_ov", "cli.parity_check", "cli.translate",
    "cli.ovlabel_extraction", "models.e2e_model", "data.e2e_dataset", "core.trees",
    "ops.align", "ops.fbank", "encoders.audio_zoo", "encoders.emotion2vec",
    "encoders.imagebind", "ops.handcrafted", "ops.opensmile_is09", "ops.egemaps",
    "cli.extract_handcrafted", "ops.opensmile_is10", "ops.opensmile_is13"))


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
