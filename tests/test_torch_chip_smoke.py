"""chip_smoke.py on a host without a card: phase 1's no-spill check on the
`ptxas -v` output, which the kernel build keeps for a reused library, and
the exit without a result."""

import os
import sys
from pathlib import Path

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from mertools_tpu_torch.ops import _kernels  # noqa: E402

DKV = "_ZN58_GLOBAL__N__333af1e6_25_flash_attention_causal_cu_1a8e2b8c9dkv_wgmmaILi{}EEEvPK13__nv_bfloat16S3_S3_PKiS3_PKfS7_PS1_S8_iiiNS_3StrES9_S9_S9_S9_S9_"
FWD = "_ZN58_GLOBAL__N__333af1e6_25_flash_attention_causal_cu_1a8e2b8c16causal_fwd_wgmmaILi{}ELi{}EEEvPK13__nv_bfloat16S3_S3_PKiPS1_PfiiNS_3StrES9_S9_S9_"
B1 = "_ZN55_GLOBAL__N__9c1d02a7_22_flash_attention_fwd_cu_5f2e9a1c15bidir_fwd_wgmmaILi{}ELi{}EEEvPK13__nv_bfloat16S3_S3_PS1_PKiiiiiiiiiiiiii"
DQ = "_ZN58_GLOBAL__N__333af1e6_25_flash_attention_causal_cu_1a8e2b8c8dq_wgmmaILi{}ELi{}EEEvPK13__nv_bfloat16S3_S3_PKiS3_PKfS7_PS1_iiNS_3StrES9_S9_S9_S9_"


def _entry(sym, regs, spill=0):
    return (f"ptxas info    : Compiling entry function '{sym}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {sym}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, "
            f"{spill + 4 if spill else 0} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers\n")


MEL = ("ptxas info    : Compiling entry function 'mel_power_fwd' for 'sm_90a'\n"
       "ptxas info    : Used 210 registers, 384 bytes cmem[0]\n")
MEL_SYM = "_ZN49_GLOBAL__N__ce112689_16_mel_power_fwd_cu_34e96c1a13mel_power_fwdEPKfPK6float2S1_PKiS1_Pfii"
# every wgmma kernel at both head dims: (entry, registers)
WGMMA = [(FWD.format(64, 3), 136), (FWD.format(128, 2), 196),
         (DKV.format(64), 130), (DKV.format(128), 216),
         (DQ.format(64, 3), 168), (DQ.format(128, 2), 254),
         (B1.format(64, 2), 125), (B1.format(128, 2), 162)]
CLEAN = "".join(_entry(sym, regs) for sym, regs in WGMMA) + MEL


def test_ptxas_usage_reads_registers_and_spills_per_kernel():
    log = _entry(DKV.format(64), 130) + _entry(DQ.format(128, 2), 168, 16) + MEL
    assert chip_smoke.ptxas_usage(log) == {
        "dkv_wgmma<64>": (130, 0, 0),
        "dq_wgmma<128,2>": (168, 16, 20),
        "mel_power_fwd": (210, 0, 0),
    }
    assert chip_smoke.ptxas_usage("") == {}


def _spilled(sym, regs):
    return CLEAN.replace(_entry(sym, regs), _entry(sym, regs, 16))


@pytest.mark.parametrize("log,match", [
    (_spilled(DQ.format(128, 2), 254), "dq_wgmma"),
    (CLEAN.replace(_entry(DKV.format(128), 216), ""), "dkv_wgmma"),
    ("", "causal_fwd_wgmma"),
    (_spilled(FWD.format(64, 3), 136), "causal_fwd_wgmma"),
    (_spilled(FWD.format(128, 2), 196), "causal_fwd_wgmma"),
    (CLEAN.replace(_entry(FWD.format(128, 2), 196), ""), "causal_fwd_wgmma"),
    (_spilled(B1.format(64, 2), 125), "bidir_fwd_wgmma"),
    (_spilled(B1.format(128, 2), 162), "bidir_fwd_wgmma"),
    (CLEAN.replace(_entry(B1.format(64, 2), 125), ""), "bidir_fwd_wgmma"),
    (CLEAN.replace(MEL, _entry(MEL_SYM, 64, 8)), "mel_power_fwd"),
    (CLEAN.replace(MEL, ""), "mel_power_fwd"),
])
def test_phase1_spill_check_fails_on_a_spill_or_a_missing_kernel(log, match):
    assert len(chip_smoke.check_no_spills(CLEAN)) == len(WGMMA) + 1
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.check_no_spills(log)


def test_a_reused_library_gives_phase1_its_build_log(tmp_path, monkeypatch):
    """A second run in the same checkout (or one after the card tests built
    the library) reuses it and still passes phase 1's check; a library
    without its log is built again."""
    runs = []

    def fake_run(cmds):
        runs.append(cmds)
        for c in cmds:
            Path(c[c.index("-o") + 1]).write_bytes(b"")
        return CLEAN if "-c" in cmds[0] else ""

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels, "_run", fake_run)
    path, secs, log = _kernels.build()
    assert path.exists() and secs > 0 and log == CLEAN and len(runs) == 2
    assert _kernels.build() == (path, 0.0, CLEAN) and len(runs) == 2
    chip_smoke.check_no_spills(_kernels.build()[2])

    path.with_suffix(".log").unlink()
    assert _kernels.build()[2] == CLEAN and len(runs) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [path.name, path.with_suffix(".log").name])


def test_busy_sum_leaves_out_host_annotations():
    """Phases 6, 7 and 10 sum the union of kernels, memcpys and memsets: a
    user annotation spanning two kernels (as Optimizer.step#AdamW.step
    does) adds nothing, overlapping kernels count once."""
    kernels = [(10.0, 30.0, "k1", "device"), (20.0, 50.0, "k2", "device"),
               (60.0, 70.0, "Memcpy HtoD", "device")]
    ann = (0.0, 100.0, "Optimizer.step#AdamW.step", "annotation")
    assert chip_smoke.busy_ms(kernels) == pytest.approx(0.05)
    assert chip_smoke.busy_ms([ann, *kernels]) == chip_smoke.busy_ms(kernels)
    assert chip_smoke.busy_ms([ann]) == 0.0


def test_exits_without_a_result_on_a_host_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


@pytest.mark.parametrize("argv", [["--fast"], ["--fast", "1"]])
def test_rejects_unknown_arguments_on_a_card(argv, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert chip_smoke.main(argv) == 2
    assert "unknown arguments" in capsys.readouterr().err


def test_phase13_character_tokenizer_round_trips_the_span_probe():
    """Phase 13b's stand-in tokenizer: [CLS] ... [SEP] inside MacBERT's
    vocabulary, and the reference's span probe finds (1, -1) on it."""
    import numpy as np

    from mertools_tpu_torch.features.text import find_token_span

    tok = chip_smoke.CharTokenizer()
    assert find_token_span(tok) == (1, -1)
    s = chip_smoke.CharTokenizer.sentence(np.random.default_rng(0), 96)
    ids = tok(s)["input_ids"]
    assert len(ids) == 96 and ids[0] == 101 and ids[-1] == 102
    assert all(672 <= i < 21128 for i in ids[1:-1])
    assert tok.decode(ids).replace(" ", "") == f"[CLS]{s}[SEP]"


def test_phase13_corpus_fills_every_token_bucket():
    import numpy as np

    from mertools_tpu_torch.features.text import DEFAULT_TOKEN_BUCKETS

    corpus = chip_smoke.text_corpus(np.random.default_rng(13))
    assert len(corpus) == 520
    batches = chip_smoke.text_batches(corpus, DEFAULT_TOKEN_BUCKETS)
    assert [b for b, _ in batches] == [16, 16, 32, 32, 64, 64, 128, 256, 512]
    assert [len(lens) for _, lens in batches] == [64] * 8 + [8]


def test_phase13_b1_checks_are_at_the_shapes_the_extractor_gives_b1(monkeypatch):
    """Phase 13 holds B1 to its plain version at ``text_batches``' (rows,
    bucket, key lengths): the shapes ``TextExtractor`` gives B1 on the
    corpus (recorded here from a narrow 1-layer BERT on the CPU)."""
    import numpy as np
    import torch

    from mertools_tpu_torch.encoders import bert as tb
    from mertools_tpu_torch.features import text as tt

    seen = []

    def record(q, k, v, kv_len):
        seen.append((q.shape[0], q.shape[1], kv_len.tolist()))
        return v

    monkeypatch.setattr(tb, "flash_attention", record)
    corpus = chip_smoke.text_corpus(np.random.default_rng(13))
    cfg = tb.BertConfig(hidden_size=16, num_hidden_layers=1, num_attention_heads=1,
                        intermediate_size=16)
    tt.TextExtractor(cfg, tb.init_params(cfg, torch.Generator().manual_seed(0)),
                     layer_ids=(-1,), batch_size=64, flash=True,
                     device="cpu").extract(corpus, level="UTT")
    want = chip_smoke.text_batches(corpus, tt.DEFAULT_TOKEN_BUCKETS)
    assert seen == [(len(lens), bucket, lens) for bucket, lens in want]


# worst-clip distances of the four modes (bf16+B1 vs bf16, bf16 vs fp32,
# bf16+B1 vs fp32, fp32+B1 vs fp32) for UTT and FRA
MACBERT = {"UTT": (1.373e-2, 1.662e-2, 1.622e-2, 1.791e-6),
           "FRA": (2.956e-2, 2.509e-2, 2.578e-2, 3.076e-6)}


def _distances(readings):
    return {k: x for lv, xs in readings.items() for k, x in zip(
        (("bf16_flash", "bf16", lv), ("bf16", "fp32", lv), ("bf16_flash", "fp32", lv),
         ("fp32_flash", "fp32", lv)), xs)}


@pytest.mark.parametrize("level, i, value, match", [
    (None, None, None, None),                     # MacBERT's readings pass
    ("UTT", 0, 5e-2, None),                       # bf16+B1 vs bf16 is not gated
    ("UTT", 2, 2.1e-2, "UTT bf16\\+B1 vs fp32"),   # over 1.25 x 1.662e-2
    ("FRA", 2, 3.2e-2, "FRA bf16\\+B1 vs fp32"),   # over 1.25 x 2.509e-2
    ("FRA", 3, 2e-4, "FRA fp32\\+B1 vs fp32"),
    ("UTT", 1, 3.1e-2, "UTT bf16 vs fp32"),       # over 3%
])
def test_feature_gates_hold_b1_to_the_inline_route(level, i, value, match):
    readings = {lv: list(xs) for lv, xs in MACBERT.items()}
    if level is not None:
        readings[level][i] = value
    if match is None:
        chip_smoke.feature_gates(_distances(readings), "13 text")
    else:
        with pytest.raises(RuntimeError, match=match):
            chip_smoke.feature_gates(_distances(readings), "13 text")


def test_b1_bound_at_the_clip_shape():
    """B 64 x T 257 x nh 16 x hd 64, every key valid: q, k, v and out are
    33.7 MB each in bf16, 134.7 MB over 3.35 TB/s; 17.3 GFLOP take less."""
    ms, by, flops = chip_smoke.b1_bound([257] * 64, "bf16", (64, 257, 16, 64))
    assert by == "bytes" and round(ms, 4) == 0.0402
    assert round(flops / 1e9, 1) == 17.3


# ------------------------------------------------------------------ phase 16
def test_phase16_draw_is_the_fidelity_tests_draw_face():
    """The port-side copy of draw_face, batched in torch: the same frames
    (noise off, float64) and ground-truth boxes."""
    import numpy as np
    import torch
    from test_face_frontend_fidelity import draw_face

    cx, cy = np.array([60.0, 71.5]), np.array([80.0, 77.0])
    got, gt = chip_smoke.draw_faces(torch, 170, 150, cx, cy, 96.0, None, noise=0.0,
                                    contrast=0.85, device="cpu")
    for t in range(2):
        ref, ref_gt = draw_face(170, 150, cx[t], cy[t], 96.0, 0.85)
        assert np.abs(got[t].numpy() - ref).max() <= 1e-9
        np.testing.assert_allclose(gt[t], ref_gt, rtol=1e-12)


def _track_clip():
    """Four drawn RGB frames and a track whose eye landmarks are the drawn
    pupils."""
    import numpy as np
    import torch

    cx, cy, s = np.array([70.0, 74, 78, 82]), np.array([90.0, 90, 91, 89]), 80.0
    img, gt = chip_smoke.draw_faces(torch, 180, 160, cx, cy, s,
                                    torch.Generator().manual_seed(0), device="cpu")
    frames = img.clamp(0, 255).to(torch.uint8)[..., None].expand(-1, -1, -1, 3).numpy()
    lms = np.stack([np.stack([cx - 0.25 * s, cy - 0.03 * s], 1),
                    np.stack([cx + 0.25 * s, cy - 0.03 * s], 1)], 1).astype(np.float32)
    track = {"lms": lms, "boxes": gt, "source": np.ones(4, np.int8),
             "detected": np.ones(4, bool), "acquired": True}
    return frames, track, gt


def test_phase16_warp_gate_fails_on_a_one_pixel_shift(monkeypatch):
    import pytest

    from mertools_tpu_torch.ops import face_align, face_haar

    frames, track, _ = _track_clip()
    fe = face_haar.HaarFaceFrontend()
    fe.track_video = lambda f: track
    host, _ = fe.crop_video(frames, warp_backend="host")
    dev, _ = fe.crop_video(frames, warp_backend="device", device="cpu")
    assert chip_smoke.warp_gate({"c": dev}, {"c": host}) < 0.1
    warp = face_align.warp_affine

    def shifted(images, affines, out_h=112, out_w=112):   # one pixel in x
        return warp(images, affines + affines.new_tensor([[0, 0, 1.0], [0, 0, 0]]),
                    out_h, out_w)

    monkeypatch.setattr(face_align, "warp_affine", shifted)
    dev, _ = fe.crop_video(frames, warp_backend="device", device="cpu")
    with pytest.raises(RuntimeError, match="16b"):
        chip_smoke.warp_gate({"c": dev}, {"c": host})


def test_phase16_blaze_gate_fails_with_symmetric_stride2_padding(monkeypatch):
    import numpy as np
    import pytest
    import torch

    from mertools_tpu_torch.ops import face_detect as fd

    torch.manual_seed(16)
    model = fd.BlazeFace(16).eval()
    sd = model.state_dict()
    x = torch.from_numpy(np.random.default_rng(0).random((2, 128, 128, 3),
                                                         np.float32))
    with torch.no_grad():
        plain = chip_smoke.blaze_plain(torch, sd, x)
        out = model(x)
        assert chip_smoke.blaze_gate(out, plain, out) == (0.0, 0.0)
        monkeypatch.setitem(fd._SAME, 2, (2, 2, 2, 2))
        out = model(x)
    with pytest.raises(RuntimeError, match="plain forward"):
        chip_smoke.blaze_gate(out, plain, out)


def test_phase16_blur_gate_fails_on_the_wrong_rate():
    import numpy as np
    import pytest
    import torch

    from mertools_tpu_torch.data.corruption import blur_frames

    frames = np.random.default_rng(4).integers(0, 256, (2, 48, 64, 3), np.uint8)
    for rate in (2, 4, 8):
        plain = chip_smoke.blur_plain(torch, torch.from_numpy(frames), rate).numpy()
        got = blur_frames(frames, rate, device="cpu")
        chip_smoke.blur_gate(got, plain, got[:1], rate)
        wrong = {2: 4, 4: 8, 8: 2}[rate]
        with pytest.raises(RuntimeError, match="plain version"):
            chip_smoke.blur_gate(blur_frames(frames, wrong, device="cpu"),
                                 plain, got[:1], rate)


def test_phase16_evaluator_gate_fails_when_numpy_takes_over(monkeypatch):
    import numpy as np
    import pytest

    from mertools_tpu_torch.ops import viola_jones as vj

    casc = vj.load_cascade(vj.find_cascade(vj.EYE))
    img = np.random.default_rng(0).integers(0, 255, (40, 40)).astype(np.float64)
    for backend in ("auto", "numpy"):
        monkeypatch.setattr(vj, "EVALUATOR_CALLS", {"native": 0, "numpy": 0})
        vj.detect_multiscale(img, casc, min_size=20, backend=backend)
        if backend == "auto":
            chip_smoke.evaluator_gate(vj.EVALUATOR_CALLS)
        else:
            with pytest.raises(RuntimeError, match="native only"):
                chip_smoke.evaluator_gate(vj.EVALUATOR_CALLS)


def test_phase16_haar_gates_fail_on_lost_or_misplaced_geometry():
    import numpy as np
    import pytest

    from mertools_tpu_torch.ops.face_haar import CORE_FACE_CAL

    _, track, gt = _track_clip()
    dx, dy, sw, sh = CORE_FACE_CAL            # raw boxes whose core box is gt
    raw = np.stack([gt[:, 2] / sw, gt[:, 3] / sh], 1)
    track["boxes"] = np.concatenate([gt[:, :2] - raw * [dx, dy], raw], 1)
    rate, med, _ = chip_smoke.haar_gates([track], [gt])
    assert rate == 1.0 and med > 0.999
    lost = dict(track, boxes=np.where(np.arange(4)[:, None] < 1, np.nan, track["boxes"]))
    with pytest.raises(RuntimeError, match="usable"):
        chip_smoke.haar_gates([lost], [gt])
    off = dict(track, boxes=track["boxes"] + [40.0, 0, 0, 0])
    with pytest.raises(RuntimeError, match="IoU"):
        chip_smoke.haar_gates([off], [gt])


def test_phase16_npz_tree_reads_back_through_from_flax():
    import torch

    from mertools_tpu_torch.ops import face_detect as fd

    sd = fd.BlazeFace(16).state_dict()
    back = fd.from_flax(chip_smoke.to_flax_tree(sd))
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
