"""The port's extract_audio CLI, mirroring tests/test_cli_extract_audio.py:
prefetch-chunked loop, idempotent skip, int16 wire, --dataset registry
resolution, on tiny random weights with --device cpu; and the package's
promise never to import JAX."""

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
    (["--model_name", "whisper-large-v3"], "A8"),
    (["--model_name", "vggish"], "A9"),
    (["--model_name", "wav2vec-large"], "wav2vec-1.0"),
    (["--model_name", "emotion2vec_base"], "A9"),
    (["--model_name", "imagebind_huge"], "A9"),
    (["--model_name", "chinese-hubert-large", "--finetuned_ckpt", "x"],
     "orbax"),
])
def test_unported_branches_exit_naming_roadmap(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        main(argv + ["--audio_dir", str(tmp_path), "--save_dir", str(tmp_path),
                     "--random_init", "--device", "cpu"])


def test_dataset_missing_from_registry_exits(tmp_path, monkeypatch):
    monkeypatch.delenv("MERTOOLS_TPU_CONFIG", raising=False)
    with pytest.raises(SystemExit, match="not in the path registry"):
        main(["--model_name", "chinese-hubert-tiny", "--dataset", "NOPE",
              "--random_init", "--device", "cpu"])


def test_port_never_imports_jax():
    """Run in a fresh interpreter: the test process itself imports JAX
    (tests/conftest.py)."""
    code = ("import sys, mertools_tpu_torch, mertools_tpu_torch.cli.extract_audio, "
            "mertools_tpu_torch.features.audio, mertools_tpu_torch.core.profiling\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
