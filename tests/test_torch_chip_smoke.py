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
