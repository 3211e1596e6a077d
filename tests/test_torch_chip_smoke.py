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
