#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mertools_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — HuBERT-large audio feature extraction at full
published width (hidden 1024, 24 layers, 16 heads) with seeded random
weights — through the entry points a user calls, and checks it:

1. device: the card's name and power limit; build the CUDA kernels from
   ``mertools_tpu_torch/csrc`` with nvcc (into ``build/kernels/``);
2. kernel vs plain: the flash-attention kernel against its plain PyTorch
   version at HuBERT-large shapes, fp32 and bf16, with CUDA-event times;
3. extraction: ``AudioExtractor`` on 64 clips of 2-10 s in four modes (fp32
   parity, bf16, bf16 + flash kernel, int16 wire + bf16 + flash kernel);
   clips/s, launch counts, cross-mode agreement, and fp32 against the
   per-clip CPU reference on two clips;
4. CLI: ``mertools_tpu_torch.cli.extract_audio`` on four PCM16 wavs.

It prints one JSON line about the kernels and, last, one JSON line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
Without a CUDA device, or without the package beside it, it exits 1 and
prints no result. It imports neither JAX nor ``transformers``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SR = 16000
KERNEL_TOL = {"fp32": 2e-5, "bf16": 1e-2}  # max|kernel - ref| / max|ref|


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20) -> list[float]:
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return ts


def phase_kernel(torch, fa):
    """Kernel vs plain version at HuBERT-large attention shapes."""
    B, T, nh, hd = 16, 499, 16, 64
    rng = np.random.default_rng(0)
    lens = [499, 480, 250, 49, 1, 0] + rng.integers(1, T + 1, B - 6).tolist()
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q0, k0, v0 = (rng.normal(size=(B, T, nh, hd)).astype(np.float32)
                  for _ in range(3))
    q0 *= hd ** -0.5
    bias = torch.where(torch.arange(T, device="cuda")[None, :] < kv_len[:, None],
                       0.0, -1e30)[:, None, None, :]
    res = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in (q0, k0, v0))
        out = fa.flash_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
        ref = fa.flash_attention_ref(q.float(), k.float(), v.float(), kv_len)
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        check(bool((out[5] == 0).all()), f"{name}: kv_len=0 row not zero")
        check(rel <= KERNEL_TOL[name], f"{name}: rel err {rel} > "
                                       f"{KERNEL_TOL[name]}")

        def inline():  # what the encoder runs with flash=False
            w = torch.softmax(torch.einsum("bqnd,bknd->bnqk", q, k)
                              + bias.to(dtype), dim=-1)
            return torch.einsum("bnqk,bknd->bqnd", w, v)

        runs = {"kernel": lambda: fa.flash_attention(q, k, v, kv_len),
                "plain": lambda: fa.flash_attention_ref(q, k, v, kv_len),
                "inline": inline}
        for f in runs.values():
            f()
        times = {n: [] for n in runs}
        for _ in range(20):  # in turns, so drift hits all three alike
            for n, f in runs.items():
                times[n] += cuda_ms(torch, f, reps=1)
        med = {n: float(np.median(t)) for n, t in times.items()}
        res[name] = dict(max_abs_err=err, rel_err=rel, ms=med["kernel"],
                         plain_ms=med["plain"], inline_ms=med["inline"])
        print(f"[2 kernel] {name} B={B} T={T} nh={nh} hd={hd} kv_len={lens}: "
              f"max_abs_err={err:.3e} rel={rel:.3e} (limit {KERNEL_TOL[name]}) "
              f"kernel {med['kernel']:.4f} ms, plain {med['plain']:.4f} ms, "
              f"encoder inline attention {med['inline']:.4f} ms "
              f"(median of 20)", flush=True)
    return res


def bench_clips():
    """bench.py's audio mix: 64 clips, 2-10 s uniform, seed 0, PCM16."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(2 * SR, 10 * SR, size=64)
    wavs16 = {f"clip{i}": (rng.normal(size=int(L)) * 3000).astype(np.int16)
              for i, L in enumerate(lengths)}
    wavs = {n: w.astype(np.float32) / 32768.0 for n, w in wavs16.items()}
    return lengths, wavs16, wavs


def rel_diff(a: dict, b: dict) -> float:
    """Worst clip's max |a - b| / max |b|."""
    return max(float(np.abs(a[n] - b[n]).max() / np.abs(b[n]).max()) for n in b)


def phase_extract(torch, fa, ta, tw, card):
    cfg = tw.Wav2Vec2Config.large()
    t0 = time.perf_counter()
    params = tw.init_params(cfg, torch.Generator().manual_seed(0))
    print(f"[3 extract] HuBERT-large random init "
          f"({sum(p.numel() for p in params.values()) / 1e6:.1f} M params) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lengths, wavs16, wavs = bench_clips()
    buckets, budget = (64000, 112000, ta.MAX_SEGMENT), 16 * ta.MAX_SEGMENT
    per_bucket = {}
    for L in lengths:
        b = next(x for x in buckets if L <= x)
        per_bucket[b] = per_bucket.get(b, 0) + 1
    n_batches = sum(math.ceil(n / max(1, budget // b))
                    for b, n in per_bucket.items())
    modes = {
        "fp32": (dict(), wavs),
        "bf16": (dict(compute_dtype="bf16"), wavs),
        "bf16_flash": (dict(compute_dtype="bf16", flash=True), wavs),
        "i16_bf16_flash": (dict(compute_dtype="bf16", flash=True,
                                transfer_dtype="int16"), wavs16),
    }
    exs = {}
    for mode, (kw, data) in modes.items():
        ex = ta.AudioExtractor(cfg, params, buckets=buckets,
                               sample_budget=budget, device="cuda", **kw)
        dt = next(iter(data.values())).dtype
        ex.extract({f"w{i}": np.zeros(b, dt) for i, b in enumerate(buckets)},
                   level="UTT")  # warm each bucket once
        exs[mode] = ex
    torch.cuda.synchronize()

    # the main path's run: counts start at 0 here and are read right after
    fa.flash_attention.launches = 0
    outs, stats = {}, {}
    for mode, (_, data) in modes.items():
        before = fa.flash_attention.launches
        t0 = time.perf_counter()
        outs[mode] = exs[mode].extract(data, level="UTT")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats[mode] = dict(clips_per_s=len(data) / dt,
                           audio_s_per_s=float(lengths.sum()) / SR / dt,
                           launches=fa.flash_attention.launches - before)
    launches = fa.flash_attention.launches

    audio_s = float(lengths.sum()) / SR
    for mode, s in stats.items():
        print(f"[3 extract] {mode}: {s['clips_per_s']:.2f} clips/s, "
              f"{s['audio_s_per_s']:.1f} audio-s/s ({len(wavs)} clips, "
              f"{audio_s:.1f} s audio, {n_batches} batches), "
              f"flash launches {s['launches']} [{card}]", flush=True)
        for name, f in outs[mode].items():
            check(f.shape == (1024,) and bool(np.isfinite(f).all()),
                  f"{mode} {name}: shape {f.shape} or non-finite")
        want = 24 * n_batches if "flash" in mode else 0
        check(s["launches"] >= want if want else s["launches"] == 0,
              f"{mode}: {s['launches']} kernel launches, want "
              f"{'>= ' if want else ''}{want}")
    d_flash = rel_diff(outs["bf16_flash"], outs["bf16"])
    d_bf16 = rel_diff(outs["bf16"], outs["fp32"])
    d_wire = rel_diff(outs["i16_bf16_flash"], outs["bf16_flash"])
    print(f"[3 extract] bf16+flash vs bf16: {d_flash:.3e} (limit 1e-2); "
          f"bf16 vs fp32: {d_bf16:.3e} (limit 3e-2); int16 wire vs f32 wire "
          f"(bf16+flash): {d_wire:.3e} (limit 3e-2)", flush=True)
    check(d_flash <= 1e-2, f"bf16+flash vs bf16 {d_flash}")
    check(d_bf16 <= 3e-2, f"bf16 vs fp32 {d_bf16}")
    check(d_wire <= 3e-2, f"int16 wire vs f32 wire {d_wire}")

    # fp32 batched on the card vs the per-clip reference on the CPU
    short = sorted(wavs, key=lambda n: len(wavs[n]))[:2]
    cpu_params = {k: v.cpu() for k, v in params.items()}
    ref = {n: ta.reference_single_clip(cfg, cpu_params, wavs[n]).mean(0)
           for n in short}
    d_ref = rel_diff({n: outs["fp32"][n] for n in short}, ref)
    print(f"[3 extract] fp32 (card, batched) vs per-clip fp32 reference "
          f"(CPU) on {short}: {d_ref:.3e} (limit 1e-3)", flush=True)
    check(d_ref <= 1e-3, f"fp32 vs CPU reference {d_ref}")
    return launches, exs["bf16"], stats


def phase_cli(torch, ex_bf16):
    from mertools_tpu_torch.cli import extract_audio

    secs = (1.0, 4.0, 7.5, 12.0)  # the 12 s clip spans two 10 s segments
    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory() as d:
        audio = os.path.join(d, "audio")
        os.makedirs(audio)
        pcm = {}
        for i, s in enumerate(secs):
            pcm[f"clip{i}"] = (rng.normal(size=int(s * SR)) * 3000).astype(np.int16)
            with wave.open(os.path.join(audio, f"clip{i}.wav"), "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(SR)
                f.writeframes(pcm[f"clip{i}"].tobytes())
        t0 = time.perf_counter()
        extract_audio.main([
            "--model_name", "chinese-hubert-large", "--audio_dir", audio,
            "--save_dir", os.path.join(d, "features"), "--random_init",
            "--encoder_size", "large", "--compute_dtype", "bf16",
            "--transfer_dtype", "int16", "--feature_level", "UTTERANCE"])
        dt = time.perf_counter() - t0
        out_dir = os.path.join(d, "features", "chinese-hubert-large-UTT")
        files = sorted(os.listdir(out_dir))
        check(files == [f"clip{i}.npy" for i in range(len(secs))],
              f"CLI wrote {files}")
        feats = {n[:-4]: np.load(os.path.join(out_dir, n)) for n in files}
    for n, f in feats.items():
        check(f.shape == (1024,) and bool(np.isfinite(f).all()),
              f"CLI {n}: shape {f.shape} or non-finite")
    # same seeded weights, same PCM: the CLI agrees with the library call
    ref = ex_bf16.extract({n: w.astype(np.float32) / 32768.0
                           for n, w in pcm.items()}, level="UTT")
    d = rel_diff(feats, ref)
    print(f"[4 cli] extract_audio wrote {len(files)} UTT features (1024,) in "
          f"{dt:.1f} s incl. model init; vs AudioExtractor bf16: {d:.3e} "
          f"(limit 3e-2)", flush=True)
    check(d <= 3e-2, f"CLI vs library {d}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it runs only on the card",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "mertools_tpu_torch")):
        print("chip_smoke: mertools_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from mertools_tpu_torch.encoders import wav2vec2 as tw
    from mertools_tpu_torch.features import audio as ta
    from mertools_tpu_torch.ops import _kernels
    from mertools_tpu_torch.ops import flash_attention as fa

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1 device] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    path, secs, log = _kernels.build()
    ptxas = [l.strip() for l in log.splitlines() if "registers" in l]
    print(f"[1 device] kernels {os.path.relpath(path, HERE)}: built in "
          f"{secs:.1f} s{'' if secs else ' (reused)'}; ptxas: {ptxas}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kres = phase_kernel(torch, fa)
    launches, ex_bf16, _ = phase_extract(torch, fa, ta, tw, card)
    phase_cli(torch, ex_bf16)

    b = kres["bf16"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mertools_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mertools_tpu/encoders/wav2vec2.py:160",
        "launches": launches,
        "max_abs_err": b["max_abs_err"],
        "ms": b["ms"],
        "plain_ms": b["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
