"""The port's train_mllm CLI, mirroring tests/test_cli_train_mllm.py on tiny
configs with --device cpu: the smoke run (data -> runner -> trainable-only
checkpoints -> a restorable model), the validation split with best selection,
resume, the multi-stream best-setup mode, epoch selection, the yaml levers,
and the exits that name the ROADMAP items left for later slices."""

import os

import numpy as np
import pytest
import torch

from mertools_tpu_torch.cli.train_mllm import build_model, main, use_b3
from mertools_tpu_torch.mllm.runner import (epoch_checkpoints, overlay_trainable,
                                            restore_model, save_model)

torch.set_num_threads(1)


def _data(tmp_path, n=6, seed=0):
    rng = np.random.default_rng(seed)
    fv, fa = tmp_path / "v", tmp_path / "a"
    fv.mkdir()
    fa.mkdir()
    names = [f"c{i}" for i in range(n)]
    for name in names:
        np.save(fv / f"{name}.npy", rng.normal(size=(5, 12)).astype(np.float32))
        np.save(fa / f"{name}.npy", rng.normal(size=(4, 10)).astype(np.float32))
    (tmp_path / "openset.csv").write_text(
        "name,openset\n" + "\n".join(f"{n},happy" for n in names) + "\n")
    (tmp_path / "reason.csv").write_text(
        "name,reason\n" + "\n".join(f"{n},smiling person" for n in names) + "\n")
    return fv, fa


def _config(tmp_path, fv, fa, run="", model=""):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"""
model:
  llm_checkpoint: tiny
  vocab_size: 96
  lora_r: 2
  video_dim: 12
  audio_dim: 10
  video_queries: 4
  audio_queries: 2
  max_video_frames: 8
{model}
datasets:
  openset_csv: {tmp_path}/openset.csv
  reason_csv: {tmp_path}/reason.csv
  video_feat_dir: {fv}
  audio_feat_dir: {fa}
run:
  max_epoch: 1
  iters_per_epoch: 3
  batch_size: 2
  warmup_steps: 2
  max_len: 64
  output_dir: {tmp_path}/out
{run}
""")
    return str(cfg)


def test_train_mllm_smoke(tmp_path):
    cfg = _config(tmp_path, *_data(tmp_path))
    main([f"--config={cfg}", "--options", "run.iters_per_epoch=2",
          "--device", "cpu"])
    out = tmp_path / "out"
    assert (out / "checkpoint_0" / "trainable.pt").exists()
    assert (out / "checkpoint_0" / "config.json").exists()
    assert (out / "log.txt").exists()
    model = restore_model(str(out / "model"), device="cpu")
    assert model.cfg.llm.vocab_size == 96
    # the saved trainable state overlays a fresh model exactly
    fresh, _ = build_model({"llm_checkpoint": "tiny", "vocab_size": 96,
                            "lora_r": 2, "video_dim": 12, "audio_dim": 10,
                            "video_queries": 4, "audio_queries": 2,
                            "max_video_frames": 8}, device="cpu", seed=5)
    assert overlay_trainable(fresh, str(out / "checkpoint_0")) == 0
    for (n, p), q in zip(fresh.named_parameters(), model.parameters()):
        if n.startswith("video_qformer") or n.endswith("lora_B"):
            assert torch.equal(p, q), n


def test_restore_model_defaults_to_the_card(tmp_path, monkeypatch):
    """restore_model loads onto the card unless asked for the CPU; on a host
    without a card the default raises instead of falling back."""
    model, _ = build_model({"llm_checkpoint": "tiny", "vocab_size": 96,
                            "lora_r": 2, "video_dim": 12, "audio_dim": 10,
                            "fusion": "mean"}, device="cpu")
    path = save_model(str(tmp_path / "model"), model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_model(path)
    got = restore_model(path, device="cpu")
    for (n, p), q in zip(model.named_parameters(), got.parameters()):
        assert torch.equal(p, q), n


def test_train_mllm_valid_split_and_resume(tmp_path, capsys):
    cfg = _config(tmp_path, *_data(tmp_path, n=8, seed=1),
                  run="  valid_frac: 0.25\n  max_epoch: 2\n  iters_per_epoch: 2",
                  model="  fusion: mean")   # no 768-wide Q-Formers: faster
    main([f"--config={cfg}", "--device", "cpu"])
    logs = capsys.readouterr().out
    assert "valid split: 2 val / 6 train clips" in logs
    assert "val_loss" in logs and "best val loss" in logs
    assert (tmp_path / "out" / "checkpoint_best").exists()
    # resume from epoch 0 for the remaining epoch
    main([f"--config={cfg}", "--device", "cpu", "--options",
          f"run.resume_ckpt_path={tmp_path}/out/checkpoint_0"])
    logs = capsys.readouterr().out
    assert "resumed from" in logs and "(epoch 0)" in logs
    assert "epoch 1:" in logs and "epoch 0:" not in logs


def test_train_mllm_best_setup_stream_mode(tmp_path, capsys):
    """The reference best setup: multiface_audio_face_text, attention fusion
    everywhere (datasets.face_or_frame, the reference's placement)."""
    fv, fa = _data(tmp_path, seed=2)
    cfg = _config(tmp_path, fv, fa,
                  model="  fusion: attention\n  multi_fusion_type: attention")
    text = open(cfg).read().replace(
        "datasets:\n", f"datasets:\n  face_or_frame: multiface_audio_face_text\n"
                       f"  face_feat_dir: {fv}\n")
    open(cfg, "w").write(text)
    main([f"--config={cfg}", "--device", "cpu", "--options", "run.max_len=160",
          "run.iters_per_epoch=2"])
    assert "epoch 0:" in capsys.readouterr().out
    model = restore_model(str(tmp_path / "out" / "model"), device="cpu")
    assert model.cfg.face_or_frame == "multiface_audio_face_text"
    assert model.cfg.video_fusion_type == model.cfg.multi_fusion == "attention"


def test_epoch_checkpoint_selection(tmp_path):
    run = str(tmp_path)
    for e in (0, 1, 2, 3, 5):
        os.makedirs(os.path.join(run, f"checkpoint_{e}"))
    os.makedirs(os.path.join(run, "checkpoint_best"))
    assert epoch_checkpoints(run) == [(5, os.path.join(run, "checkpoint_5"))]
    assert epoch_checkpoints(run, test_epoch="2") == \
        [(2, os.path.join(run, "checkpoint_2"))]
    assert [e for e, _ in epoch_checkpoints(run, test_epochs="0-3",
                                            skip_epoch=2)] == [0, 2]
    assert [e for e, _ in epoch_checkpoints(run, test_epochs="1-5",
                                            skip_epoch=2)] == [2]
    with pytest.raises(FileNotFoundError):
        epoch_checkpoints(run, test_epoch="9")
    with pytest.raises(FileNotFoundError):
        epoch_checkpoints(str(tmp_path / "empty"))


def test_build_model_yaml_levers():
    base = {"llm_checkpoint": "tiny", "vocab_size": 96, "lora_r": 2,
            "video_dim": 12, "audio_dim": 10, "fusion": "mean"}
    m, tok = build_model(dict(base), device="cpu")
    assert tok is None
    assert m.cfg.llm.remat is False and m.cfg.loss_chunk == 0
    assert not m.cfg.llm.use_flash_attention and m.cfg.llm.head_dim == 8
    m, _ = build_model(dict(base, remat=True, remat_policy="dots", loss_chunk=64,
                            llm_hidden_size=256), device="cpu")
    assert m.cfg.llm.remat and m.cfg.llm.remat_policy == "dots"
    assert m.cfg.loss_chunk == 64 and m.cfg.llm.head_dim == 64
    # kernel B3 is chosen by the device and the head dim, not by a key
    assert not m.cfg.llm.use_flash_attention
    assert use_b3("cuda:0", m.cfg.llm) and not use_b3("cpu", m.cfg.llm)
    assert not use_b3("cuda", build_model(dict(base), device="cpu")[0].cfg.llm)
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(dict(base, remat=True, remat_policy="dot"), device="cpu")


def test_build_model_defaults_to_the_card(monkeypatch):
    """build_model builds on the card unless asked for the CPU; on a host
    without a card the default raises instead of falling back."""
    base = {"llm_checkpoint": "tiny", "vocab_size": 96, "lora_r": 2,
            "video_dim": 12, "audio_dim": 10, "fusion": "mean"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(dict(base))
    m, _ = build_model(dict(base), device="cpu")
    assert next(m.parameters()).device.type == "cpu"


@pytest.mark.parametrize("argv,extra,match", [
    (["--n_model", "2"], "", "A14"),
    (["--n_seq", "2"], "", "A14"),
    (["--n_pipe", "2"], "", "A14"),
    ([], "  face_dir: /nonexistent\n  audio_dir: /nonexistent\n", "A9d"),
])
def test_unported_paths_exit_naming_roadmap(tmp_path, argv, extra, match):
    cfg = _config(tmp_path, *_data(tmp_path))
    if extra:
        text = open(cfg).read().replace("datasets:\n", "datasets:\n" + extra)
        open(cfg, "w").write(text)
    with pytest.raises(SystemExit, match=match):
        main([f"--config={cfg}", "--device", "cpu"] + argv)


def test_real_checkpoint_needs_transformers_only_for_the_tokenizer(
        tmp_path, monkeypatch):
    """A non-tiny llm_checkpoint: config.json and weights load through the
    port; without transformers the tokenizer step exits naming it."""
    import json
    import sys

    from mertools_tpu_torch.mllm.llm import LLM, LLMConfig

    cfg = LLMConfig.tiny(vocab=40)
    ckpt = tmp_path / "llm"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": 40, "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "intermediate_size": 64,
        "rms_norm_eps": 1e-6}))
    sd = {f"model.{k}": v for k, v in LLM(cfg).state_dict().items()}
    torch.save(sd, ckpt / "pytorch_model.bin")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit, match="transformers"):
        build_model({"llm_checkpoint": str(ckpt), "video_dim": 12,
                     "audio_dim": 10}, device="cpu")
