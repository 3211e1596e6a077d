"""chip_smoke.py on a host without a card: phase 1's no-spill check on the
`ptxas -v` output, which the kernel build keeps for a reused library, and
the exit without a result."""

import os
import sys
from pathlib import Path

import numpy as np
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


def test_phase17_topn_widths_name_the_top6_of_every_ranking():
    from mertools_tpu_torch.data.dataset import TopNFeatureDataset

    names = TopNFeatureDataset.feature_names(6, "AVT")
    assert len(names) == 18 == len(set(names))
    assert sorted(chip_smoke.TOPN_WIDTHS) == sorted(names)
    assert chip_smoke.TOPN_WIDTHS["chinese-hubert-large"] == 1024
    assert chip_smoke.TOPN_WIDTHS["baichuan2-7b-base"] == 4096


@pytest.mark.parametrize("n_train,folds", [(3373, 5), (3373, 2), (83, 3)])
def test_phase17_fold_steps_count_the_first_folds_training_batches(n_train, folds):
    import math

    import numpy as np

    from mertools_tpu_torch.data import cv

    train_idx, _ = cv.kfold_indices(n_train, folds, np.random.default_rng(0))[0]
    assert chip_smoke.fold_steps(n_train, 3, folds) == 3 * math.ceil(len(train_idx) / 32)


def test_phase17_frame_stores_hold_12c_spans_compressed():
    import numpy as np

    emos = np.arange(600) % 6
    for _, dim, lo, hi in chip_smoke.FRM_FEATURES:
        rows = chip_smoke.frm_features(np.random.default_rng(0), emos, dim, lo, hi)
        lens = np.array([len(r) for r in rows])
        assert lens.min() >= -(-lo // 6) and lens.max() <= -(-hi // 6)
        assert lens.max() - lens.min() >= (hi - lo) // 6 - 2  # ragged over the span
        assert all(r.shape[1] == dim and r.dtype == np.float32 for r in rows)
        means = np.stack([np.concatenate([r for r, e in zip(rows, emos) if e == c]).mean(0)
                          for c in range(6)])
        assert np.abs(means[0] - means[1]).mean() > 0.1  # class-separable


@pytest.mark.parametrize("feat_type,scale", [("utt", None), ("frm_align", "1"),
                                             ("frm_unalign", "2")])
def test_phase17_flags_parse_in_main_release(feat_type, scale):
    from mertools_tpu_torch.cli import main_release

    flags = chip_smoke.zoo_flags("/d", "mfn", feat_type, 1, "cuda")
    ns, unknown = main_release.build_parser().parse_known_args(flags)
    assert unknown == [] and ns.model == "mfn" and ns.feat_type == feat_type
    assert ns.device == "cuda" and ns.seed == 0 and ns.epochs == 1
    assert ns.feat_scale == (None if scale is None else int(scale))
    suffix = "UTT" if feat_type == "utt" else "FRA"
    assert all(f.endswith(suffix) for f in (ns.audio_feature, ns.text_feature, ns.video_feature))


@pytest.mark.parametrize("model", ["tfn", "mfm", "mult", "attention_topn"])
def test_phase17_seed0_hyperparameters_are_the_jax_clis_draw(model):
    import numpy as np

    from mertools_tpu.cli import main_release as j_main_release
    from mertools_tpu.core.config import load_yaml, random_select

    space = load_yaml(os.path.normpath(j_main_release._TUNE_YAML))[model]
    assert chip_smoke.seed0_hp(model) == random_select(space, np.random.default_rng(0))


def test_phase17_card_vs_cpu_turns_dropout_off_and_fixes_the_prior():
    """On the CPU both legs are the same model: every distance is 0 only
    if the check turns off each dropout (MISA's transformer too) and hands
    MFM one prior for both; a fresh prior a call would move the logits."""
    import numpy as np

    hp = {"hidden_dim": 16, "mem_dim": 8, "dropout": 0.5, "lr": 1e-3,
          "lda_xl": 0.1, "lda_xa": 0.1, "lda_xv": 0.1, "lda_mmd": 10.0}
    sets = chip_smoke.zoo_sets(np.random.default_rng(0), "frm_align",
                               {"train": 40, "test1": 8})
    assert chip_smoke.zoo_card_vs_cpu(__import__("torch"), "mfm", hp, sets, "cpu",
                                      "frm_align") == (0.0, 0.0)
    hp = {"hidden_dim": 16, "dropout": 0.5, "lr": 1e-3}
    sets = chip_smoke.zoo_sets(np.random.default_rng(0), "utt", {"train": 40, "test1": 8})
    assert chip_smoke.zoo_card_vs_cpu(__import__("torch"), "misa", hp, sets, "cpu",
                                      "utt") == (0.0, 0.0)


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


def test_phase17_times_the_runs_last_epoch_only(monkeypatch):
    """``RunProbe`` lets every epoch of a run through, times (on a card:
    profiles) only the n-th, the run's last, and each fold's start."""
    import torch

    from mertools_tpu_torch.train import loop

    seen = []
    monkeypatch.setattr(loop, "run_epoch", lambda model, *a: seen.append(a) or len(seen))
    model = torch.nn.Linear(2, 2)
    monkeypatch.setattr(loop, "init_model", lambda *a: model)
    with chip_smoke.RunProbe(torch, 3) as p:
        for i in range(4):
            if i % 2 == 0:
                assert loop.init_model() is model
            assert loop.run_epoch(model, i) == i + 1
        assert p.prof[0] >= 0 and p.prof[2] == 0
        assert p.first_fold_s() > 0 and len(p.starts) == 2
    assert loop.run_epoch(model, 9) == 5  # restored


def test_phase17_union_is_the_busy_sum():
    import numpy as np

    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1000, 500)
    b = a + rng.exponential(5, 500)
    evs = [(x, y, "k", "device") for x, y in zip(a, b)]
    assert chip_smoke.union_ms(a, b) == pytest.approx(chip_smoke.busy_ms(evs), rel=1e-12)
    assert chip_smoke.union_ms(np.array([0.0, 5.0]), np.array([10.0, 7.0])) == 0.01
    assert chip_smoke.union_ms(np.array([]), np.array([])) == 0.0


def test_phase18_prompt_mix_spans_the_bucket_and_the_budgets():
    prompts = chip_smoke.serving_prompts(np.random.default_rng(18), 8, 64, 448, 32000)
    lens = sorted(map(len, prompts))
    assert len(prompts) == 8 and lens[0] == 64 and lens[-1] == 448
    assert all(3 <= t < 32000 for p in prompts for t in p)
    reqs = chip_smoke.engine_requests(np.random.default_rng(18), chip_smoke.ENGINE_MIX, 32000)
    assert len(reqs) == 64
    assert min(len(p) for p, _ in reqs) == 16 and max(len(p) for p, _ in reqs) == 448
    assert min(n for _, n in reqs) == 16 and max(n for _, n in reqs) == 128


def test_phase18_marginal_rate_needs_the_longer_call_to_take_longer():
    step, tok_s = chip_smoke.marginal_rate({64: 500.0, 128: 900.0}, 8)
    assert step == pytest.approx(6.25) and tok_s == pytest.approx(8 * 1e3 / 6.25)
    for t128 in (500.0, 480.0):
        with pytest.raises(RuntimeError, match="marginal decode rate"):
            chip_smoke.marginal_rate({64: 500.0, 128: t128}, 8)


def test_phase18_launch_check_fails_on_any_launch():
    def wrapper():
        pass

    wrapper.launches = 0
    assert chip_smoke.no_launches([wrapper], "phase 18") == {"wrapper": 0}
    wrapper.launches = 1
    with pytest.raises(RuntimeError, match="phase 18 launched"):
        chip_smoke.no_launches([wrapper], "phase 18")


def test_phase18_decode_bound_counts_weights_once_and_the_cache():
    """At TinyLlama's geometry (no LoRA, meta tensors): bf16 weights without
    the embedding table plus B of its rows; int8 weights halve the linear
    part; each cached token adds its K and V per layer."""
    import dataclasses

    import torch

    from mertools_tpu_torch.mllm import generate as tg
    from mertools_tpu_torch.mllm import llm as tl

    cfg = tl.LLMConfig(**{**chip_smoke.SERVE_LLM, "lora_r": 0})
    model = tl.LLM(cfg, device="meta").to(torch.bfloat16)
    ms, by, n_bytes = chip_smoke.decode_step_bound(model, 8, 0, False)
    n_w = sum(p.numel() for p in model.parameters()) - cfg.vocab_size * cfg.hidden_size
    assert n_bytes == 2 * n_w + 2 * 8 * cfg.hidden_size and by == "bytes"
    assert ms == pytest.approx(n_bytes / chip_smoke.HBM_BPS * 1e3)
    _, _, with_kv = chip_smoke.decode_step_bound(model, 8, 1000, False)
    assert with_kv - n_bytes == 2 * 22 * 4 * 1000 * 64 * 2
    _, _, with_kv8 = chip_smoke.decode_step_bound(model, 8, 1000, True)
    assert with_kv8 - n_bytes == 2 * 22 * 4 * 1000 * (64 + 4)
    assert dataclasses.asdict(cfg)["num_layers"] == 22
    w8 = tg.quantize_llm_w8(tl.LLM(dataclasses.replace(cfg, num_layers=1, vocab_size=64,
                                                       hidden_size=64, num_heads=4,
                                                       num_kv_heads=2,
                                                       intermediate_size=96)))
    _, _, w8_bytes = chip_smoke.decode_step_bound(tg.cast_llm_bf16(w8), 1, 0, False)
    n_lin = sum(m.q.numel() for m in w8.modules() if isinstance(m, tg.W8Linear))
    n_scale = sum(m.scale.numel() for m in w8.modules() if isinstance(m, tg.W8Linear))
    assert w8_bytes == n_lin + 2 * n_scale + 2 * 3 * 64 + 2 * 64   # 3 norms, 1 row


def test_phase18_stand_in_tokenizer_stays_in_the_vocabulary():
    tok = chip_smoke.LLMCharTokenizer(32000)
    ids = tok.encode("情绪 happy", add_special_tokens=True)
    assert ids[0] == 1 and all(3 <= i < 32000 for i in ids[1:])
    text = tok.decode([1, 2, *ids[1:]])
    assert len(text) == len(ids) - 1 and text.isalpha()   # specials skipped


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
    mix = {"B": 3, "lo": 40, "hi": 70, "new": (2, 12), "reps": 2}
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


def test_phase19_tone_corpus_is_seeded_and_two_classes():
    a, labels_a = chip_smoke.tone_corpus(np.random.default_rng(0), 6, 2.0, 3.0)
    b, _ = chip_smoke.tone_corpus(np.random.default_rng(0), 6, 2.0, 3.0)
    assert sorted(a) == sorted(labels_a) == [f"tone{i:03d}" for i in range(6)]
    for n in a:
        assert a[n].dtype == np.int16 and np.array_equal(a[n], b[n])
        assert 2 * chip_smoke.SR <= len(a[n]) <= 3 * chip_smoke.SR
    assert {v["emo"] for v in labels_a.values()} == {"neutral", "angry"}
    # the two classes are the two tones: the spectrum peaks at 200 or 500 Hz
    for i, n in enumerate(sorted(a)):
        spec = np.abs(np.fft.rfft(a[n].astype(np.float64)))
        peak = np.argmax(spec) * chip_smoke.SR / len(a[n])
        assert abs(peak - (200.0, 500.0)[i % 2]) < 2.0


def test_phase19_seeded_checkpoint_reads_back_through_build_e2e_model(tmp_path):
    """The phase's writer gives the directory ``--pretrain_dir`` names:
    ``build_e2e_model`` reads its config and weights back without
    ``transformers``, for each of the three modalities."""
    import torch

    from mertools_tpu_torch.core.config import Args
    from mertools_tpu_torch.models import e2e_model as tm

    for name, tiny in (("chinese-hubert-large", "tiny-audio"),
                       ("chinese-macbert-large", "tiny-text"),
                       ("clip-vit-large-patch14", "tiny-video")):
        model, _ = tm.build_e2e_model(Args(e2e_name=tiny))
        sd = model.init_backbone(torch.Generator().manual_seed(0))
        chip_smoke.write_seeded_checkpoint(str(tmp_path), name, model.backbone.cfg, sd)
        back, got = tm.build_e2e_model(Args(e2e_name=name, pretrain_dir=str(tmp_path)))
        assert back.backbone.cfg == model.backbone.cfg
        assert sorted(got) == sorted(sd) and all(torch.equal(got[k], v) for k, v in sd.items())
        back.backbone.load_state_dict(got, strict=True)


@pytest.mark.parametrize("bf16,int8,ok", [
    (1.095e-2, 1.775e-2, True),     # HuBERT-large's readings
    (6.003e-3, 9.911e-3, True),     # CLIP-L's
    (1e-2, 3e-2, True),             # at the limit
    (1e-2, 3.01e-2, False),
    (1e-3, 2e-2, False),            # int8 far off while bf16 is close
])
def test_phase19_int8_gate(bf16, int8, ok):
    d = {"bf16": bf16, "int8": int8}
    if ok:
        assert chip_smoke.int8_gate(d, "19d x") == pytest.approx(int8 / bf16)
    else:
        with pytest.raises(RuntimeError, match="19d x UTT int8 vs fp32"):
            chip_smoke.int8_gate(d, "19d x")


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


def test_phase17_reads_each_store_once_and_restores_the_reader(tmp_path):
    from mertools_tpu_torch.data import feature_store

    for n in ("a", "b"):
        feature_store.write_feature(str(tmp_path / "s"), n, np.full(3, ord(n), np.float32))
    read = feature_store.read_features
    with chip_smoke.stores_read_once() as memo:
        first, dim = feature_store.read_features(str(tmp_path / "s"), ["a", "b"])
        os.remove(tmp_path / "s" / "a.npy")          # a second read would fail
        again, _ = feature_store.read_features(str(tmp_path / "s"), ["a", "b"])
        assert again is first and dim == 3 and len(memo) == 1
        assert [float(x[0, 0]) for x in first] == [97.0, 98.0]
    assert feature_store.read_features is read


def test_phase19_step_flop_counts_the_backbone_from_its_shapes():
    """HuBERT-large on 2 s windows: 99 frames a window, ~60.8 GFLOP of
    transformer products, ~9.8 of the conv frontend and ~1.7 of the
    positional conv forward; x 3 for a step, 256 windows: ~55.6 TFLOP."""
    from mertools_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config

    cfg = Wav2Vec2Config.large()
    one = chip_smoke.e2e_step_flop(cfg, 1, 32000) / 3
    assert cfg.feat_lengths(32000) == 99
    layers = 24 * (2 * 99 * (4 * 1024 ** 2 + 2 * 1024 * 4096) + 4 * 99 ** 2 * 1024)
    assert 70e9 < one < 73e9 and one - layers > 11e9
    assert round(chip_smoke.e2e_step_flop(cfg, 256, 32000) / 1e12, 2) == 55.55


def test_phase20_clips_reach_the_whole_clip_buckets_above_10_s():
    """Phase 3's 64 clips and 4 seeded ones of 20-45 s: the whole-clip
    buckets of 20, 30 or 60 s are reached, and the draw repeats."""
    from mertools_tpu_torch.features.audio import WHOLECLIP_BUCKETS

    a, b = chip_smoke.zoo_clips(), chip_smoke.zoo_clips()
    _, bench, _ = chip_smoke.bench_clips()
    assert len(a) == 68 and all(np.array_equal(a[n], bench[n]) for n in bench)
    assert all(np.array_equal(a[n], b[n]) and a[n].dtype == np.int16 for n in a)
    longs = [len(a[f"long{i}"]) for i in range(4)]
    assert all(20 * 16000 <= n < 45 * 16000 for n in longs)
    buckets = {next(x for x in WHOLECLIP_BUCKETS if n <= x) for n in longs}
    assert buckets and min(buckets) > 160000


def test_phase20_kept_rows_follow_the_trim_rules():
    """VGGish keeps max(frames // 96, 1) patches, wav2vec 1.0 its valid-conv
    frames, emotion2vec max(out_lengths, 1), ImageBind its 8 clips; a clip
    past the last bucket (60 s) counts as truncated."""
    from mertools_tpu_torch.encoders.audio_zoo import Wav2Vec1Config
    from mertools_tpu_torch.encoders.emotion2vec import Emotion2VecConfig

    w2v, e2v = Wav2Vec1Config(), Emotion2VecConfig()
    assert [chip_smoke.kept_rows("vggish", n, None) for n in (300, 16000, 31000, 10 ** 6)] \
        == [1, 1, 2, 62]
    assert chip_smoke.kept_rows("wav2vec1", 16000, w2v) == 98
    assert chip_smoke.kept_rows("emotion2vec", 16000, e2v) == 49
    assert chip_smoke.kept_rows("emotion2vec", 300, e2v) == 1
    assert chip_smoke.kept_rows("emotion2vec", 10 ** 6, e2v) == 2999
    assert chip_smoke.kept_rows("imagebind", 5, None) == 8


@pytest.mark.parametrize("value,limit,ok", [
    (2.9e-4, chip_smoke.ZOO_CPU_TOL, True), (3.1e-4, chip_smoke.ZOO_CPU_TOL, False),
    (5e-5, chip_smoke.ZOO_RAGGED_TOL, True), (6e-5, chip_smoke.ZOO_RAGGED_TOL, False),
    (float("nan"), chip_smoke.ZOO_CLI_TOL, False)])
def test_phase20_gates(value, limit, ok):
    if ok:
        assert chip_smoke.zoo_gate(value, limit, "x") == value
    else:
        with pytest.raises(RuntimeError, match="x "):
            chip_smoke.zoo_gate(value, limit, "x")


def _tiny_imagebind(monkeypatch):
    """The port's ImageBind config narrowed to 16 wide and 3 blocks
    (the loaders fix the huge one)."""
    from mertools_tpu_torch.encoders import imagebind as ib

    cls = ib.ImageBindAudioConfig
    monkeypatch.setattr(ib, "ImageBindAudioConfig", lambda **kw: cls(**{
        **dict(embed_dim=16, num_blocks=3, num_heads=4, out_embed_dim=24), **kw}))


@pytest.mark.parametrize("family", ["vggish", "wav2vec1", "emotion2vec", "imagebind"])
def test_phase20_checkpoint_writer_key_layout(tmp_path, monkeypatch, family):
    """Each file is in the reference's layout under the name the CLI looks
    for, and the CLI's loader reads the model's weights back from it."""
    import torch

    from mertools_tpu_torch.cli.extract_audio import load_zoo

    _tiny_imagebind(monkeypatch)
    fields = {"emotion2vec": dict(hidden_size=48, prenet_depth=1, depth=1,
                                  conv_layers=((16, 10, 5), (16, 3, 2)))}.get(family, {})
    _, sd = chip_smoke.zoo_model(family, "cpu", 0, **fields)
    path = chip_smoke.write_zoo_checkpoint(str(tmp_path), family, sd)
    assert os.path.basename(path) == {"vggish": "vggish.pt", "wav2vec1": "wav2vec-large.pt",
                                      "emotion2vec": "emotion2vec_base.pt",
                                      "imagebind": "imagebind_huge.pth"}[family]
    blob = torch.load(path, weights_only=False)
    if family == "wav2vec1":
        assert sorted(blob) == ["args", "model"] and blob["model"].keys() == sd.keys()
    elif family == "emotion2vec":
        assert sorted(blob) == ["cfg", "model"]
        assert {k for k in blob["model"] if k.startswith("_ema.")} == {
            f"_ema.{k}" for k in sd if k.startswith("blocks.")} != set()
        assert "modality_encoders.AUDIO.decoder.proj.weight" in blob["model"]
    elif family == "imagebind":
        assert set(blob) - set(sd) == {"modality_trunks.vision.blocks.0.attn.bias_k",
                                       "modality_postprocessors.audio.1.log_logit_scale"}
    else:
        assert blob.keys() == sd.keys()
    name = os.path.splitext(os.path.basename(path))[0]
    got = load_zoo(family, name, str(tmp_path), False, "cpu").model.state_dict()
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)


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
