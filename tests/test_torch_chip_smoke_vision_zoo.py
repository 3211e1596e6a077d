"""chip_smoke.py's phase 22 (the ViT vision zoo) on the CPU: its clips, its
unit and FLOP counts at the published geometries, and the whole phase at a
small size, so every check it makes runs before a chip call."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SMALL = dict(hidden_size=32, num_layers=3, num_heads=4, intermediate_size=64)
CONFIGS = {"dinov2": dict(SMALL, image_size=28), "data2vec": dict(SMALL, image_size=32),
           "videomae": dict(SMALL, image_size=32), "siglip": dict(SMALL, image_size=28,
                                                                   patch_size=7),
           # the CLI reads EVA-G's heads from no shape: they stay the published 16
           "eva_clip_g": dict(SMALL, hidden_size=64, num_heads=16, image_size=28)}


def test_phase22_clips_reach_the_resample_and_the_repeat_pad():
    clips = chip_smoke.vz_clips()
    lengths = [len(c) for c in clips.values()]
    assert len(clips) == 16 and min(lengths) >= 8 and max(lengths) <= 80
    assert lengths[0] > 64 and lengths[1] < 16
    assert all(c.shape[1:] == (112, 112, 3) and c.dtype == np.uint8 for c in clips.values())
    # DINOv2, EVA-G and SigLIP resample the long clip to 64; data2vec keeps it
    assert chip_smoke.vz_units("data2vec", clips) - chip_smoke.vz_units("dinov2", clips) == 16
    assert chip_smoke.vz_units("videomae", clips) == 16


def test_phase22_flops_and_seeded_weights_at_the_published_geometries():
    """One unit's FLOP (a frame; a clip for VideoMAE) at each family's
    published width and tokens, within 15% of 2 params x tokens plus the
    attention (the issue's sizing); the seeded towers load strictly, with
    weights at std 0.02, unit norms, zero biases, LayerScale at its value."""
    from mertools_tpu_torch.encoders import siglip as ts
    from mertools_tpu_torch.encoders import vit as tv

    for family, tflop, tokens in (("dinov2", 1.0, 1370), ("videomae", 1.2, 1568),
                                  ("siglip", 0.65, 729), ("eva_clip_g", 0.52, 257),
                                  ("data2vec", 0.035, 197)):
        cfg = chip_smoke.vz_config(family)
        assert getattr(cfg, "seq_len", cfg.num_patches) == tokens, family
        assert chip_smoke.vz_flops(cfg) / 1e12 == pytest.approx(tflop, rel=0.15), family
    cfg = chip_smoke.vz_config("data2vec", **SMALL)
    sd = chip_smoke.vz_init("data2vec", cfg, "cpu", 0)
    tv.ViTEncoder(cfg).load_state_dict(sd, strict=True)
    assert float(sd["blocks.1.fc1.weight"].std()) == pytest.approx(0.02, rel=0.2)
    assert (sd["blocks.0.ls2"] == 0.1).all() and (sd["blocks.0.norm1.weight"] == 1).all()
    assert (sd["blocks.0.q.bias"] == 0).all() and "blocks.0.k.bias" not in sd
    assert float(sd["blocks.0.rel_bias_table"].std()) == pytest.approx(0.02, rel=0.2)
    scfg = chip_smoke.vz_config("siglip", **SMALL, image_size=28)
    ssd = chip_smoke.vz_init("siglip", scfg, "cpu", 0)
    ts.SiglipVisionEncoder(scfg).load_state_dict(ssd, strict=True)
    assert (ssd["vision_model.head.attention.in_proj_bias"] == 0).all()


def test_phase22_fp32_batch_is_one_batch_of_the_mix():
    clips = chip_smoke.vz_clips()
    for family in chip_smoke.VZ_FAMILIES:
        one = chip_smoke.vz_one_batch(family, clips)
        n = chip_smoke.vz_units(family, one)
        assert 0.75 * chip_smoke.VZ_BATCH.get(family, 64) < n <= chip_smoke.VZ_BATCH.get(family, 64)
        assert len(one) > 2 and "face01" in one     # the shortest clips, the 8-frame one first
    assert len(chip_smoke.vz_one_batch("videomae", clips)) == 8


def test_phase22_runs_end_to_end_on_the_cpu_at_a_small_size(capsys):
    """Every family narrowed to 3 layers of width 32 (the check and CLI legs
    cut to 2), on four clips of 3-70 frames: every gate passes (bf16 vs
    fp32, card vs CPU, ToMe finite, the CLI's stores against the library
    call, the checkpoints in the publishers' layouts) and each part prints."""
    import torch

    rng = np.random.default_rng(0)
    clips = {f"c{i}": rng.integers(0, 256, (n, 112, 112, 3), np.uint8)
             for i, n in enumerate((70, 8, 12, 3))}
    res = chip_smoke.phase_vision_zoo(torch, "cpu", "cpu", clips=clips, configs=CONFIGS,
                                      n_check=2)
    out = capsys.readouterr().out
    assert list(res) == list(chip_smoke.VZ_FAMILIES)
    for family in chip_smoke.VZ_FAMILIES:
        assert out.count(f"[22 vision zoo] {family} (a) ") == 2
        assert res[family]["cli"] <= chip_smoke.VZ_CLI_TOL
        assert ("tome" in res[family]) == (family in chip_smoke.VZ_TOME)
    for name in ("dinov2-large", "data2vec-vision-base", "videomae-large",
                 "siglip-so400m-patch14-384", "eva-clip-g.pth"):
        assert f"(e) extract_vision.main on {name} " in out
