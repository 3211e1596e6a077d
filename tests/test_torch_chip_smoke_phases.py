"""chip_smoke.py's phases 17-21 end to end on the CPU at small sizes, so
each phase's orchestration and every check it makes run before a chip
call (their helpers' cases are in ``test_torch_chip_smoke.py``)."""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from test_torch_chip_smoke import _tiny_imagebind  # noqa: E402


def test_phase17_runs_end_to_end_on_the_cpu_at_a_small_size(monkeypatch, capsys):
    """The phase's orchestration on the CPU (no profile there) with two
    models, narrow stores and tiny splits: every check it makes passes and
    it prints a line for each run, top-N and the sweep."""
    import torch

    monkeypatch.setattr(chip_smoke, "ZOO_UTT", ("lmf",))
    monkeypatch.setattr(chip_smoke, "ZOO_FRM", ("mfn",))
    monkeypatch.setattr(chip_smoke, "FUSION_FEATURES",
                        tuple((f, 8 + i) for i, (f, _) in enumerate(chip_smoke.FUSION_FEATURES)))
    monkeypatch.setattr(chip_smoke, "FRM_FEATURES",
                        tuple((f, 6 + i, lo, hi) for i, (f, _, lo, hi)
                              in enumerate(chip_smoke.FRM_FEATURES)))
    monkeypatch.setattr(chip_smoke, "TOPN_WIDTHS", {k: 4 for k in chip_smoke.TOPN_WIDTHS})
    res = chip_smoke.phase_fusion_zoo(
        torch, "cpu", dev="cpu", splits={"train": 40, "test1": 8, "test2": 8, "test3": 10},
        epochs={"utt": 1, "frm": 1, "topn": 1, "sweep": 1})
    out = capsys.readouterr().out
    assert sorted(res) == ["lmf utt", "mfn frm_align", "mult frm_unalign", "sweep", "topn"]
    assert out.count("[17 zoo] a/b:") == 3 and "[17 zoo] c: top-N" in out
    assert "carried into both repeats" in out
    assert all(r["wall"] > 0 for r in res.values())  # each run's last epoch, timed


def test_phase18_runs_end_to_end_on_the_cpu_at_a_small_size(monkeypatch, capsys):
    """The phase's orchestration on the CPU (no profile there) at a narrow
    geometry and small mixes: every check it makes passes (cached against
    full forward, w8 against dequantized, int8 KV, engine against generate
    with and without the shared prefix, beams, the CLIs) and it prints a
    rate for each of the four generate modes and the engine."""
    import torch

    monkeypatch.setattr(chip_smoke, "CHECK_LAYERS", 2)
    llm = dict(vocab_size=300, hidden_size=64, num_layers=3, num_heads=4, num_kv_heads=2,
               intermediate_size=96, lora_r=2)
    # 32 decode steps between the two calls, the faster of 3 each: on a
    # loaded host 10 steps were within the noise of the marginal-rate guard
    mix = {"B": 3, "lo": 40, "hi": 70, "new": (2, 34), "reps": 3}
    engine = {"n": 5, "lo": 16, "hi": 60, "new_lo": 2, "new_hi": 6, "slots": 3,
              "chunk": 4, "buckets": (32, 64)}
    affect = {"video_dim": 12, "audio_dim": 10, "frames": 8, "clips": 3,
              "qformer": dict(hidden_size=16, num_layers=1, num_heads=2,
                              intermediate_size=32)}
    rates = chip_smoke.phase_serving(torch, "cpu", dev="cpu", llm=llm, mix=mix,
                                     engine=engine, affect=affect)
    out = capsys.readouterr().out
    assert sorted(rates) == ["bf16", "engine", "kv_int8", "w8", "w8+kv_int8"]
    assert all(r["tok_s"] > 0 for r in rates.values())
    assert out.count("[18 serving] a: generate") == 4
    assert "0 of 24 differ" in out and "beams equal" in out and "texts equal" in out


def test_phase19_runs_end_to_end_on_the_cpu_at_a_small_size(capsys):
    """The phase's orchestration on the CPU (no profile or peak memory
    there) at narrow widths and small sizes: every check it makes passes
    (losses, the saved backbone, card vs CPU, the read-back and the
    refusal, the int8 gate and sites) and it prints each part."""
    import torch

    from mertools_tpu_torch.encoders.bert import BertConfig
    from mertools_tpu_torch.encoders.vit_clip import CLIPVisionConfig
    from mertools_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config

    acfg = Wav2Vec2Config(hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                          intermediate_size=48, conv_dim=(16,) * 7,
                          conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
                          num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2,
                          feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True)
    tcfg = BertConfig(hidden_size=16, num_hidden_layers=3, num_attention_heads=2,
                      intermediate_size=32)
    vcfg = CLIPVisionConfig(hidden_size=16, num_hidden_layers=3, num_attention_heads=2,
                            intermediate_size=32, image_size=32, patch_size=16,
                            projection_dim=12)
    audio = dict(chip_smoke.E2E_AUDIO, clips=12, lo_s=0.3, hi_s=0.5, nseg=2, seglen=3200,
                 batch=4, fallback_batch=2)
    chip_smoke.phase_e2e(torch, "cpu", "cpu", acfg, tcfg, vcfg, audio=audio,
                         text_vision=dict(text_clips=12, video_clips=8, batch=4),
                         int8_sizes=(4, 2))
    out = capsys.readouterr().out
    for part in ("a: main_release", "a: card vs CPU", "b: extract_audio", "d: int8 at"):
        assert out.count(f"[19 e2e] {part}") == 1, part
    assert out.count("[19 e2e] c: ") == 2 and out.count("[19 e2e] d: ") == 3
    assert "leaf shapes do not match the selected model architecture" in out


def test_phase20_runs_end_to_end_on_the_cpu_at_a_small_size(monkeypatch, capsys):
    """The phase's orchestration on the CPU (no profile or peak memory
    there): VGGish at its published width, emotion2vec narrowed, and
    wav2vec 1.0 and ImageBind narrowed where their loaders fix their
    configs, on six short clips and one of 10.6 s; every check passes and
    each part prints."""
    import torch

    from mertools_tpu_torch.encoders import audio_zoo
    from mertools_tpu_torch.encoders.emotion2vec import CONV_LAYERS_BASE

    _tiny_imagebind(monkeypatch)
    w2v1 = audio_zoo.Wav2Vec1Config
    monkeypatch.setattr(audio_zoo, "Wav2Vec1Config", lambda **kw: w2v1(**{
        **dict(enc_layers=((32, 10, 5), (32, 8, 4)), ctx_layers=((32, 3), (32, 3))), **kw}))
    rng = np.random.default_rng(0)
    wavs16 = {f"c{i}": (rng.normal(size=int(n)) * 3000).astype(np.int16)
              for i, n in enumerate(rng.integers(6000, 20000, size=6))}
    wavs16["long"] = (rng.normal(size=170000) * 3000).astype(np.int16)
    e2v = dict(conv_layers=tuple((16, k, s) for _, k, s in CONV_LAYERS_BASE), hidden_size=48,
               prenet_depth=1, depth=2, conv_pos_depth=2, conv_pos_width=10,
               conv_pos_groups=4)
    res = chip_smoke.phase_audio_zoo(torch, "cpu", "cpu", wavs16=wavs16,
                                     configs={"emotion2vec": e2v}, n_check=2, n_cli=2)
    out = capsys.readouterr().out
    assert sorted(res) == sorted(chip_smoke.ZOO_FAMILIES)
    for family in chip_smoke.ZOO_FAMILIES:
        assert out.count(f"[20 audio zoo] {family} (a): ") == 2
        assert out.count(f"[20 audio zoo] {family} (b) card vs CPU") == 1
    assert out.count("(c) ragged vs alone: not run") == 2
    assert "wav2vec-large-z-FRA, wav2vec-large-c-FRA" in out


def test_phase21_runs_end_to_end_on_the_cpu_at_a_small_size(monkeypatch, capsys):
    """Phase 21 on the CPU with four clips across three buckets, one pass,
    two of (b)'s clips."""
    import torch

    rng = np.random.default_rng(0)
    wavs16 = {f"c{i}": (rng.normal(size=int(n)) * 3000).astype(np.int16)
              for i, n in enumerate((300, 2 * 16000, 4.5 * 16000, 5 * 16000))}
    checks = {n: w for n, w in chip_smoke.hc_check_clips().items() if n in ("tone140", "noise")}
    monkeypatch.setattr(chip_smoke, "HC_CLI_CLIPS", 3)
    res = chip_smoke.phase_handcrafted(torch, "cpu", "cpu", wavs16=wavs16, check_clips=checks,
                                       passes=1)
    out = capsys.readouterr().out
    assert set(res) == set(chip_smoke.HC_SETS)
    for fs in chip_smoke.HC_SETS:   # a rate line, and a profile line if it is profiled
        assert out.count(f"[21 handcrafted] {fs} (a): ") == 1 + (fs in chip_smoke.HC_PROFILED)
        assert res[fs]["cpu"] == 0.0 and res[fs]["utt_clips_s"] > 0
    for fs in ("IS09", "eGeMAPS", "IS10", "IS13"):
        assert res[fs]["ragged"] <= 1.0, fs
    assert "UTT columns off it: none off it" in out
    assert "(d): extract_handcrafted.main, 6 sets x 2 levels on 3 wavs" in out
