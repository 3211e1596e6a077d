#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mertools_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls, at full
published width with seeded random weights — HuBERT-large audio feature
extraction (hidden 1024, 24 layers, 16 heads), Whisper-large-v2 features and
ASR (d_model 1280, 32 + 32 layers, 20 heads, vocab 51865), AffectGPT LoRA
training at TinyLlama-1.1B width (hidden 2048, 22 layers, 32 heads, 4 KV
heads, vocab 32000), the MERBench fusion trainer (attention fusion, hidden
256, 5-fold CV) at MER2023's split sizes, MacBERT-large text features
(vocab 21128, hidden 1024, 24 layers, 16 heads, 512 positions) and
CLIP-ViT-L/14 vision features (224 px, patch 14, 257 tokens, hidden 1024,
24 layers, projection 768), MER2023's trimodal pipeline, and the face
frontend that makes its face stores from frames — and checks them:

1. device: the card's name and power limit; build the CUDA kernels from
   ``mertools_tpu_torch/csrc`` with nvcc (into ``build/kernels/``);
2. kernel vs plain: the flash-attention kernel (B1) against its plain
   PyTorch version at HuBERT-large shapes, fp32 and bf16, with device times
   beside SDPA with the key mask;
3. extraction: ``AudioExtractor`` on 64 clips of 2-10 s in four modes (fp32
   parity, bf16, bf16 + flash kernel, int16 wire + bf16 + flash kernel);
   clips/s, launch counts, cross-mode agreement, and fp32 against the
   per-clip CPU reference on two clips;
4. CLI: ``mertools_tpu_torch.cli.extract_audio`` on four PCM16 wavs;
5. mel kernel vs plain: the fused log-mel kernel (B2) against its plain
   version (cuFFT) at B = 8 x 30 s: its launch shape and ptxas usage, device
   times, and the plain version's parts timed one by one;
6. Whisper features: ``WhisperAudioExtractor`` on 16 clips of 2-30 s, f32
   and int16 wires; clips/s, launch counts, kernel against plain frontend
   end to end, a profile of one batch, and the card against the CPU (2 + 2
   layers of the same weights);
7. Whisper ASR: ``WhisperASR.transcribe_batch`` on 8 clips; encode and
   decode rates, a profile of one decode, and the cached decode steps
   against the full decoder;
8. CLIs: ``extract_audio`` on Whisper (tiny random config) and
   ``main_asr merge`` / ``punctuate``;
9. B3: the causal flash attention's four kernels (forward, di pre-pass,
   dK/dV, dQ) against their plain version and autograd at TinyLlama's
   attention (B 8, S 512, ragged padding; fp32 and bf16; hd 64 and 128),
   di/dQ/dK/dV bit-equal across two launches, device times beside SDPA's
   forward, backward alone and fwd+bwd, and at B 4 x S 1024;
10. training: bench.py's AffectGPT step (B 8 x S 512, bf16, chunked loss)
   through ``Runner.train_step`` on kernel B3, a warm-up step and 10 timed
   steps (tokens/s, memory, launch counts, the loss trajectory), a profile
   of one step, the executed FLOP, layer 0's LoRA gradients of both bf16
   attention paths against an fp32 eager copy, the same steps with eager
   attention, and fp32 on the card against the CPU at full width with 2
   LLM layers;
11. CLI: ``train_mllm`` on synthetic features (best-setup stream mode),
   2 epochs, then resumed for a third;
12. the fusion trainer: (a) ``extract_audio`` writes HuBERT-large UTT
   features of 40 wavs and ``main_release`` trains attention fusion on them
   (hidden 256, 5 folds), on the card and on the CPU, test1 logits compared;
   (b) ``main_release`` at MER2023's split sizes (3373 train, test1/2/3 of
   411/412/834) on seeded class-separable UTT features at 1024/1024/768,
   10 epochs: cv WAF, seconds a fold and an epoch, steps/s, and the device
   idle share of one epoch from a profile; (c) ``run_cv`` on frm_align
   features with LSTM encoders, card against CPU from the same weights (a
   step's gradients, a trained model's test logits) beside how far two
   trainings drift. It launches none of the port's kernels;
13. text: (a) ``TextExtractor.extract`` on 520 seeded sentences of 8-96
   tokens and 16 of 200-510 (every token bucket holds a batch), batch 64,
   UTT and FRA, in four modes (fp32 parity, fp32 + B1, bf16, bf16 + B1):
   sentences/s, B1 launches, the modes against each other, the card
   against the CPU (3 layers of the same weights), a profile of one
   bf16+B1 batch, B1 against its plain version at every batch's rows,
   bucket and key lengths and its device times at each bucket; (b) the
   text CLI's extraction loop on a transcription CSV with an empty row,
   and ``extract_text.main`` on a ``config.json`` + ``pytorch_model.bin``
   directory (3 layers), both through a character-level tokenizer, against
   the library;
14. vision: (a) ``VisionExtractor.extract`` on 32 seeded clips of 50-250
   face crops (112 x 112 BGR uint8), at most 64 frames a clip, in the same
   four modes with the same checks (frames/s and clips/s; the card
   against the CPU at 2 layers), a profile of one batch, B1 at B 64 x T
   257 beside its bound and SDPA; (b) ToMe r 8 beside the full tower; (c)
   ``extract_vision.main`` on a ``config.json`` + ``pytorch_model.bin``
   directory (2 layers) against the library on the same weights;
15. trimodal: 12a's 40 clips, each with a seeded transcript and face
   crops, get HuBERT-large, MacBERT-large and CLIP-L UTT features, then
   ``main_release`` attention fusion on the three, on the card and on the
   CPU; as in 12c the card is held to the CPU from the same weights and
   the two whole runs' distance is printed;
16. faces: 40 clips of 12-36 drawn 640 x 360 RGB frames (phase 15's names;
   a face drifting 4 px a frame, every fourth clip with a mouth occluder):
   (a) ``preprocess detect-faces``, the Haar route (host detection and
   tracking, the warp on the card), gated against the drawn truth (usable
   geometry, core-face IoU) and on the native evaluator having run; (b)
   ``crop_video``'s device warp against its host warp; (c) BlazeFace at
   width 32 against its plain functional forward and the CPU, its frames/s
   and idle share, and ``detect-faces --detector_params``; (d)
   ``blur_frames`` at rates 2, 4 and 8 against its plain version and the
   CPU; (e) CLIP-L UTT features of (a)'s face stores, then ``main_release``
   with phase 15's HuBERT and MacBERT features, card against CPU. B1's
   launches are printed by path (phases 3, 13, 14, 15 and 16) and summed in
   the kernels line.

    python3 chip_smoke.py --b3-times DIR

prints only phase 9's bf16 timing lines, phase 2's bf16 B1 line and phase
5's B2 line for the port in the checkout DIR (an earlier commit unpacked
beside this one), to compare versions of the kernels (B1, B2, B3) within
one call.

Before each path runs, its kernels' launch counts are set to 0; they are
read right after it. It prints one JSON line about the kernels and, last, one JSON line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
Without a CUDA device, or without the package beside it, it exits 1 and
prints no result. It imports neither JAX nor ``transformers``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SR = 16000
KERNEL_TOL = {"fp32": 2e-5, "bf16": 1e-2}  # max|kernel - ref| / max|ref|
# B2: both sides fp32 FFTs (the kernel's own vs cuFFT), so rounding only
MEL_TOL = 1e-5      # max |kernel - ref| / max |ref| per clip
LOG_MEL_TOL = 1e-4  # abs, in the (log10 + 4) / 4 domain
# B3 against its plain version, max |kernel - ref| / max |ref|: fp32 differs
# in summation order only; bf16 rounds P and dS to bf16 inside the products
# and the outputs to 8 mantissa bits (forward, dQ/dK/dV)
B3_TOL = {"fp32": (1e-5, 1e-4), "bf16": (1e-2, 2e-2)}
LSE_TOL = 1e-4      # abs: the row logsumexp is fp32 on both sides
# each B3 kernel against its own plain version on the same bf16 inputs, max
# |kernel - ref| / max |ref|: di is an fp32 row sum on both sides
B3_KERNEL_TOL = {"fwd": 1e-2, "prep": 1e-5, "dkv": 2e-2, "dq": 2e-2}
LLM_FLASH_TOL = 4.7e-3  # flash vs eager LLM loss, relative (PARITY.md:179-181)
# flash vs eager LoRA gradients in bf16, max |flash - eager| / max |eager|;
# a wrong attention backward moves them by O(1)
LORA_GRAD_TOL = 5e-2
# H100 SXM peaks (NVIDIA data sheet, dense): the least time a kernel could
# take is the larger of its bytes over HBM3 and its operations over the peak
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "fp32": 67e12}


def bound(n_bytes: float, flops: float, kind: str) -> tuple[float, str]:
    """(least ms for the work, "bytes" or "operations")."""
    t_mem, t_ops = n_bytes / HBM_BPS * 1e3, flops / PEAK[kind] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def ptxas_usage(log: str) -> dict:
    """``-Xptxas -v`` per kernel: {"name<template args>": (registers, spill
    store bytes, spill load bytes)}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = demangle(m.group(1))
            out[name] = [0, 0, 0]
        elif name and "spill stores" in line:
            out[name][1:] = [int(x) for x in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line)]
        elif name and "registers" in line:
            out[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return {k: tuple(v) for k, v in out.items()}


def demangle(sym: str) -> str:
    """A kernel's mangled name as ``name<args>``: the last component of its
    nested name and its integer template arguments."""
    j, parts = (3 if sym.startswith("_ZN") else 2), []
    while j < len(sym) and sym[j].isdigit():
        k = j
        while sym[k].isdigit():
            k += 1
        parts.append(sym[k:k + int(sym[j:k])])
        j = k + int(sym[j:k])
    args = []
    if sym[j:j + 1] == "I":
        args = re.findall(r"L(?:i|j|b)(\d+)E", sym[j:sym.find("EE", j) + 2])
    name = parts[-1] if parts else sym
    return f"{name}<{','.join(args)}>" if args else name


# the kernels phase 1 holds to no spills, with how many builds each has: the
# wgmma kernels at hd 64 and 128, B2 once; no name is a prefix of another
SPILL_CHECKED = {"causal_fwd_wgmma": 2, "dkv_wgmma": 2, "dq_wgmma": 2,
                 "bidir_fwd_wgmma": 2, "mel_power_fwd": 1}


def check_no_spills(log: str) -> dict:
    """Phase 1: the bf16 wgmma kernels (B3's forward, dK/dV and dQ, and
    B1's, at both head dims) and B2 appear in the build's ``ptxas -v``
    output (this build's, or the one kept beside a reused library) without
    spill bytes. Returns every kernel's usage."""
    usage = ptxas_usage(log)
    for name, builds in SPILL_CHECKED.items():
        got = {k: u for k, u in usage.items() if k.startswith(name)}
        check(len(got) == builds and all(u[1] == u[2] == 0 for u in got.values()),
              f"{name}: ptxas reports {got}, want {builds} build(s) without spills")
    return usage


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ~5 ms of device clock: long enough for the host to queue a kernel's
# wrapper (or a plain version's dozens of ops) behind it
SLEEP_CYCLES = 10_000_000


def cuda_ms(torch, fn, reps: int = 20, device_only: bool = False) -> list[float]:
    """CUDA-event ms of ``fn`` per rep. With ``device_only`` the device first
    sleeps while the host queues the start event and ``fn``'s launches, so
    the window holds device time only, not the wrapper's Python (the kernel
    tables use this); without, the host's queueing counts too."""
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return ts


B1_SHAPE = (16, 499, 16, 64)   # HuBERT-large attention: B, T, nh, hd


def b1_inputs(torch, dtype, shape=B1_SHAPE, lens=None):
    """q (pre-scaled), k, v at ``shape`` from seed 0 and key lengths: phase
    2's ragged ones (with a row of length 1 and one of 0) unless ``lens``
    is given."""
    B, T, nh, hd = shape
    rng = np.random.default_rng(0)
    if lens is None:
        lens = [499, 480, 250, 49, 1, 0] + rng.integers(1, T + 1, B - 6).tolist()
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q0, k0, v0 = (rng.normal(size=(B, T, nh, hd)).astype(np.float32)
                  for _ in range(3))
    q0 *= hd ** -0.5
    q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in (q0, k0, v0))
    return q, k, v, kv_len, lens


def b1_bound(lens, kind: str, shape=B1_SHAPE) -> tuple[float, str, float]:
    """(bound ms, "bytes" or "operations", FLOP) of one B1 call at
    ``shape``: q, k, v read and out written once; both products over the
    keys each row attends to (rows with kv_len 0 do none)."""
    B, T, nh, hd = shape
    es = 4 if kind == "fp32" else 2
    flops = 4.0 * hd * nh * T * sum(min(n, T) for n in lens)
    return (*bound(4.0 * B * T * nh * hd * es + 4 * B, flops, kind), flops)


def b1_check(torch, fa, q, k, v, kv_len, kind: str):
    """B1 against its plain version on the same inputs: (output, max abs
    error, error / max|ref|); fails on a non-finite output or an error over
    ``KERNEL_TOL[kind]``."""
    out = fa.flash_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    ref = fa.flash_attention_ref(q.float(), k.float(), v.float(), kv_len)
    err = (out.float() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    check(bool(torch.isfinite(out).all()), f"{kind}: non-finite output")
    check(rel <= KERNEL_TOL[kind], f"{kind}: rel err {rel} > {KERNEL_TOL[kind]}")
    return out, err, rel


def b1_times(torch, fa, q, k, v, kv_len, plain: bool) -> dict:
    """Device-only CUDA-event medians of 20, in turns, so drift hits all
    alike: the kernel and SDPA with the key mask (the yardstick, never
    called by the port); with ``plain``, the plain version and the
    encoder's inline attention (what it runs with flash=False)."""
    T = q.shape[1]
    bias = torch.where(torch.arange(T, device="cuda")[None, :] < kv_len[:, None],
                       0.0, -1e30)[:, None, None, :]

    def inline():
        w = torch.softmax(torch.einsum("bqnd,bknd->bnqk", q, k)
                          + bias.to(q.dtype), dim=-1)
        return torch.einsum("bnqk,bknd->bqnd", w, v)

    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    key_ok = (bias == 0)    # (B, 1, 1, T)
    runs = {"kernel": lambda: fa.flash_attention(q, k, v, kv_len)}
    if plain:
        runs.update(plain=lambda: fa.flash_attention_ref(q, k, v, kv_len),
                    inline=inline)
    runs["library"] = lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=key_ok, scale=1.0)
    for f in runs.values():
        f()
    times = {n: [] for n in runs}
    for _ in range(20):
        for n, f in runs.items():
            times[n] += cuda_ms(torch, f, reps=1, device_only=True)
    return {n: float(np.median(t)) for n, t in times.items()}


def phase_kernel(torch, fa, card):
    """Kernel vs plain version at HuBERT-large shapes."""
    B, T, nh, hd = B1_SHAPE
    res = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v, kv_len, lens = b1_inputs(torch, dtype)
        out, err, rel = b1_check(torch, fa, q, k, v, kv_len, name)
        check(bool((out[5] == 0).all()), f"{name}: kv_len=0 row not zero")
        med = b1_times(torch, fa, q, k, v, kv_len, plain=True)
        b_ms, b_by, flops = b1_bound(lens, name)
        res[name] = dict(max_abs_err=err, rel_err=rel, ms=med["kernel"],
                         plain_ms=med["plain"], inline_ms=med["inline"],
                         library_ms=med["library"], bound_ms=b_ms, bound_by=b_by)
        print(f"[2 kernel] {name} B={B} T={T} nh={nh} hd={hd} kv_len={lens}: "
              f"max_abs_err={err:.3e} rel={rel:.3e} (limit {KERNEL_TOL[name]}) "
              f"kernel {med['kernel']:.4f} ms, plain {med['plain']:.4f} ms, "
              f"encoder inline attention {med['inline']:.4f} ms, SDPA with the "
              f"key mask {med['library']:.4f} ms (median of 20); bound "
              f"{b_ms:.4f} ms by {b_by} ({flops / 1e9:.2f} GFLOP) [{card}]",
              flush=True)
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
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
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
          f"(bf16+flash): {d_wire:.3e} (limit 3e-2) [{card}]", flush=True)
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
          f"(CPU) on {short}: {d_ref:.3e} (limit 1e-3) [{card}]", flush=True)
    check(d_ref <= 1e-3, f"fp32 vs CPU reference {d_ref}")
    return launches, exs["bf16"], stats


def phase_cli(torch, ex_bf16, card):
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
          f"(limit 3e-2) [{card}]", flush=True)
    check(d <= 3e-2, f"CLI vs library {d}")


# ------------------------------------------------------------------ Whisper
def mel_inputs(torch):
    """B = 8 x 480000 from seed 0: sines, noise, a zero row, a +-1 square,
    DC offsets."""
    n = 480000
    t = np.arange(n) / SR
    rng = np.random.default_rng(0)
    wav = np.zeros((8, n), np.float32)
    wav[0, :64000] = 0.4 * np.sin(2 * np.pi * 440 * t[:64000])
    wav[1] = 0.2 * np.sin(2 * np.pi * 3000 * t) + 0.01 * rng.normal(size=n)
    wav[2] = rng.normal(size=n) * 0.1
    wav[3, :32000] = rng.normal(size=32000) * 0.5
    # wav[4] stays zero: a filler row
    wav[5] = np.sign(np.sin(2 * np.pi * 200 * t + 0.1))
    wav[6] = 0.3
    wav[7] = 0.3 + 0.05 * rng.normal(size=n)
    return torch.from_numpy(wav).cuda()


def mel_bound(mel) -> tuple[float, str, float, int]:
    """(bound ms, "bytes" or "operations", FLOP, filterbank nonzeros) of B2
    at B = 8 x 30 s: the wav read and the mel power written once; the
    operations the function needs per frame (not a dense DFT): the window,
    a 400-point real FFT (2.5 N log2 N), the power of 201 bins and the
    filterbank's nonzero entries; fp32."""
    frames = 480000 // 160
    nnz = int(np.count_nonzero(mel.filter_bank()))
    flops = 8 * frames * (400 + 2.5 * 400 * math.log2(400) + 3 * 201 + 2.0 * nnz)
    return (*bound(4.0 * 8 * (480000 + frames * 80), flops, "fp32"), flops, nnz)


def mel_times(torch, mf, mel, x, parts: bool) -> dict:
    """Device-only CUDA-event medians of 20, in turns: B2 and its plain
    version ``mel_power_ref``; with ``parts``, also both log-mel frontends
    and the plain version taken apart (``ops/mel.py:mel_power_spectrum``):
    its two table uploads from numpy, the framing and window, ``rfft``, the
    power, the filterbank matmul, and the whole with its tables already on
    the card."""
    runs = {"kernel": lambda: mf.mel_power(x), "plain": lambda: mf.mel_power_ref(x)}
    if parts:
        import torch.nn.functional as F

        def uploads():
            return (torch.from_numpy(mel.hann_window()).to(x.device),
                    torch.from_numpy(mel.filter_bank().T.copy()).to(x.device))

        win, fb = uploads()

        def frame():
            pad = F.pad(x[:, None, :], (200, 200), mode="reflect")[:, 0]
            return pad.unfold(-1, 400, 160)[:, : x.shape[1] // 160] * win

        def placed():
            spec = torch.fft.rfft(frame(), dim=-1)
            return (spec.real ** 2 + spec.imag ** 2) @ fb

        fw = frame()
        spec = torch.fft.rfft(fw, dim=-1)
        pw = spec.real ** 2 + spec.imag ** 2
        runs.update({
            "log_mel_fused": lambda: mf.log_mel_spectrogram_fused(x),
            "log_mel": lambda: mel.log_mel_spectrogram(x),
            "uploads": uploads, "frame_window": frame,
            "rfft": lambda: torch.fft.rfft(fw, dim=-1),
            "power": lambda: spec.real ** 2 + spec.imag ** 2,
            "matmul": lambda: pw @ fb, "plain_tables_placed": placed})
    for f in runs.values():
        f()
    times = {n: [] for n in runs}
    for _ in range(20):  # in turns, so drift hits all alike
        for n, f in runs.items():
            times[n] += cuda_ms(torch, f, reps=1, device_only=True)
    return {n: float(np.median(t)) for n, t in times.items()}


def phase_mel(torch, mel, mf, card, usage: dict):
    """Kernel B2 against its plain version (cuFFT + matmul) at B = 8: its
    launch shape and ptxas usage, the gates, the times of the kernel and of
    the plain version's parts."""
    x = mel_inputs(torch)
    plan = mf.kernel_plan(x.device)
    print(f"[5 mel] B2 launch: {plan['threads']} threads x {plan['frames']} "
          f"frames a block, {plan['blocks_per_clip']} blocks a clip "
          f"({plan['blocks_per_clip'] * x.shape[0]} at B={x.shape[0]}), "
          f"{plan['smem_bytes']} B of shared memory, {plan['blocks_per_sm']} "
          f"blocks an SM (occupancy API), {plan['registers']} registers; ptxas "
          f"(registers, spill store/load bytes) {usage['mel_power_fwd']} "
          f"[{card}]", flush=True)
    out = mf.mel_power(x)
    torch.cuda.synchronize()
    ref = mf.mel_power_ref(x)
    check(bool(torch.isfinite(out).all()), "B2: non-finite output")
    check(bool((out[4] == 0).all()), "B2: zero row not exactly zero")
    err = (out - ref).abs().max().item()
    rel = max(((out[b] - ref[b]).abs().max() / ref[b].abs().max()).item()
              for b in range(8) if b != 4)
    d_log = (mel.log_mel_from_power(out)
             - mel.log_mel_from_power(ref)).abs().max().item()
    check(rel <= MEL_TOL, f"B2: mel power rel err {rel} > {MEL_TOL}")
    check(d_log <= LOG_MEL_TOL, f"B2: log-mel err {d_log} > {LOG_MEL_TOL}")
    med = mel_times(torch, mf, mel, x, parts=True)
    b_ms, b_by, flops, nnz = mel_bound(mel)
    print(f"[5 mel] bound {b_ms:.4f} ms by {b_by} ({flops / 1e9:.3f} GFLOP "
          f"with an FFT and {nnz} filterbank nonzeros) [{card}]", flush=True)
    print(f"[5 mel] B2 B=8x480000 (sine, sine+noise, noise, short noise, zero, "
          f"square, DC, DC+noise): max_abs_err={err:.3e}, worst clip "
          f"{rel:.3e} of max|ref| (limit {MEL_TOL}), log-mel max abs err "
          f"{d_log:.3e} (limit {LOG_MEL_TOL}); kernel {med['kernel']:.4f} ms "
          f"({b_ms / med['kernel']:.3f} of its bound), mel_power_ref "
          f"{med['plain']:.4f} ms; log_mel_spectrogram_fused "
          f"{med['log_mel_fused']:.4f} ms, log_mel_spectrogram "
          f"{med['log_mel']:.4f} ms (median of 20) [{card}]", flush=True)
    print(f"[5 mel] mel_power_ref taken apart (device ms, median of 20): "
          f"window + filterbank uploads {med['uploads']:.4f}, framing + window "
          f"{med['frame_window']:.4f}, rfft {med['rfft']:.4f}, power "
          f"{med['power']:.4f}, filterbank matmul {med['matmul']:.4f} (sum "
          f"{sum(med[n] for n in ('uploads', 'frame_window', 'rfft', 'power', 'matmul')):.4f}"
          f"); the whole with its tables already on the card "
          f"{med['plain_tables_placed']:.4f}, with its uploads {med['plain']:.4f} "
          f"[{card}]", flush=True)
    return dict(max_abs_err=err, rel_err=rel, log_err=d_log, ms=med["kernel"],
                plain_ms=med["plain"], bound_ms=b_ms, bound_by=b_by)


def whisper_clips():
    """16 clips of 2-30 s, uniform, seed 0, PCM16."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(2 * SR, 30 * SR + 1, size=16)
    wavs16 = {f"clip{i}": (rng.normal(size=int(L)) * 3000).astype(np.int16)
              for i, L in enumerate(lengths)}
    wavs = {n: w.astype(np.float32) / 32768.0 for n, w in wavs16.items()}
    return lengths, wavs16, wavs


def busy_ms(events) -> float:
    """Device-busy ms of profiler events given as (start us, end us, name,
    kind) tuples: the union of the intervals of device work (kind "device":
    kernels, memcpys, memsets). A host range that the profiler draws on the
    device timeline (kind "annotation", e.g. ``Optimizer.step#AdamW.step``)
    is left out."""
    busy, end = 0.0, -math.inf
    for a, b, _, kind in sorted(events):
        if kind == "device":
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
    return busy / 1e3


def device_profile(torch, fn):
    """One call of fn under torch.profiler: (wall ms, device-busy ms by
    :func:`busy_ms`, top 5 device ops by summed time in ms, ms of each host
    range left out, the busy ms had those ranges counted too). The profiler
    marks a user annotation on the device timeline with
    ``FunctionEvent.is_user_annotation``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [(e.time_range.start, e.time_range.end, e.name,
            "annotation" if e.is_user_annotation else "device")
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_kind = {"device": {}, "annotation": {}}
    for a, b, name, kind in evs:
        by_kind[kind][name] = by_kind[kind].get(name, 0.0) + (b - a) / 1e3
    top = sorted(by_kind["device"].items(), key=lambda kv: -kv[1])[:5]
    with_ranges = busy_ms([(a, b, n, "device") for a, b, n, _ in evs])
    return wall, busy_ms(evs), top, by_kind["annotation"], with_ranges


def profile_line(busy: float, top, left_out: dict, with_ranges: float,
                 base_ms: float) -> str:
    """The profile's numbers as phases 6, 7 and 10 print them; the idle
    share is of ``base_ms``."""
    tops = ", ".join(f"{n[:60]} {t:.1f} ms" for n, t in top)
    outs = ", ".join(f"{n[:60]} {t:.1f} ms" for n, t in left_out.items()) or "none"
    return (f"device busy {busy:.1f} ms (kernels, memcpys, memsets; host "
            f"ranges left out: {outs}; {with_ranges:.1f} ms with them), idle "
            f"share {1 - busy / base_ms if busy else float('nan'):.3f}; top "
            f"device ops: {tops}")


def phase_whisper_features(torch, mel, mf, tws, ta, card):
    cfg = tws.WhisperConfig.large_v2()
    t0 = time.perf_counter()
    params = tws.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    print(f"[6 whisper] whisper-large-v2 geometry (d_model 1280, 32 + 32 "
          f"layers, 20 heads, FFN 5120, vocab 51865), random init on the card "
          f"({n_params / 1e6:.1f} M params) {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    lengths, wavs16, wavs = whisper_clips()
    audio_s = float(lengths.sum()) / SR
    n_batches = math.ceil(len(wavs) / 8)
    exs = {"f32": (ta.WhisperAudioExtractor(cfg, params, device="cuda"), wavs),
           "int16": (ta.WhisperAudioExtractor(cfg, params, device="cuda",
                                              transfer_dtype="int16"), wavs16)}
    for ex, data in exs.values():  # warm up
        ex.extract({f"w{i}": np.zeros(SR, next(iter(data.values())).dtype)
                    for i in range(8)}, level="UTT")
    torch.cuda.synchronize()

    # the main path's run: the count starts at 0 here and is read right after
    mf.mel_power.launches = 0
    outs, stats = {}, {}
    for wire, (ex, data) in exs.items():
        before = mf.mel_power.launches
        t0 = time.perf_counter()
        outs[wire] = ex.extract(data, level="UTT")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stats[wire] = dict(clips_per_s=len(data) / dt, audio_s_per_s=audio_s / dt,
                           launches=mf.mel_power.launches - before)
    launches = mf.mel_power.launches
    for wire, st in stats.items():
        print(f"[6 whisper] {wire} wire: {st['clips_per_s']:.3f} clips/s, "
              f"{st['audio_s_per_s']:.1f} audio-s/s ({len(wavs)} clips of "
              f"2-30 s, {audio_s:.1f} s audio, {n_batches} batches of 8 x 30 s), "
              f"B2 launches {st['launches']} [{card}]", flush=True)
        check(st["launches"] >= n_batches,
              f"{wire}: {st['launches']} B2 launches < {n_batches} batches")
        for name, f in outs[wire].items():
            check(f.shape == (1280,) and bool(np.isfinite(f).all()),
                  f"{wire} {name}: shape {f.shape} or non-finite")
    d_wire = rel_diff(outs["int16"], outs["f32"])

    ex = exs["f32"][0]
    ex.log_mel = mel.log_mel_spectrogram  # the plain frontend, on the card
    plain = ex.extract(wavs, level="UTT")
    ex.log_mel = mf.log_mel_spectrogram_fused
    d_plain = rel_diff(outs["f32"], plain)

    wall, *prof = device_profile(
        torch, lambda: ex.extract(dict(list(wavs.items())[:8]), level="UTT"))
    print(f"[6 whisper] profile of one f32 batch (8 clips): wall {wall:.1f} ms, "
          f"{profile_line(*prof, wall)} [{card}]", flush=True)

    # card fp32 vs CPU fp32 at full width, 2 + 2 layers of the same weights
    cfg2 = dataclasses.replace(cfg, encoder_layers=2, decoder_layers=2)
    keep = {k: v for k, v in params.items()
            if ".layers." not in k or int(k.split(".layers.")[1].split(".")[0]) < 2}
    short = {n: wavs[n] for n in sorted(wavs, key=lambda n: len(wavs[n]))[:1]}
    gpu2 = ta.WhisperAudioExtractor(cfg2, keep, batch_size=1,
                                    device="cuda").extract(short, level="FRA")
    cpu2 = ta.WhisperAudioExtractor(cfg2, {k: v.cpu() for k, v in keep.items()},
                                    batch_size=1, device="cpu").extract(short,
                                                                        level="FRA")
    d_cpu = rel_diff(gpu2, cpu2)
    print(f"[6 whisper] int16 wire vs f32 wire: {d_wire:.3e} (limit 1e-5); "
          f"B2 vs plain log-mel end to end: {d_plain:.3e} (limit 1e-4); card "
          f"vs CPU fp32 (2 + 2 layers, {list(short)}, FRA): {d_cpu:.3e} "
          f"(limit 1e-3) [{card}]", flush=True)
    check(d_wire <= 1e-5, f"int16 vs f32 wire {d_wire}")
    check(d_plain <= 1e-4, f"B2 vs plain log-mel end to end {d_plain}")
    check(d_cpu <= 1e-3, f"card vs CPU {d_cpu}")
    return cfg, params, wavs, launches, stats


def phase_asr(torch, mf, tws, tasr, tdec, cfg, params, wavs, card):
    B, max_new = 8, 32
    asr = tasr.WhisperASR(cfg, params, batch_size=B, max_new_tokens=max_new,
                          device="cuda")
    clips = list(wavs.values())[:B]
    asr.transcribe_batch([np.zeros(SR, np.float32)] * B)  # warm up
    torch.cuda.synchronize()

    # the main path's run: the count starts at 0 here and is read right after
    mf.mel_power.launches = 0
    t0 = time.perf_counter()
    toks = asr.transcribe_batch(clips)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mf.mel_power.launches
    check(launches >= 1, f"ASR: {launches} B2 launches")
    check(len(toks) == B and all(len(t) <= max_new for t in toks),
          f"ASR: token lists {[len(t) for t in toks]}")

    batch = np.zeros((B, 480000), np.float32)
    for r, w in enumerate(clips):
        batch[r, : min(len(w), 480000)] = w[:480000]
    enc_ms = float(np.median(cuda_ms(torch, lambda: asr.encode(batch), reps=3)))
    enc = asr.encode(batch)
    P = len(asr.prompt)
    prompt = torch.tensor([asr.prompt] * B, dtype=torch.int32)
    dec_ms = float(np.median(cuda_ms(torch, lambda: tdec.greedy_decode(
        cfg, asr.model, enc, prompt, P, max_new), reps=3)))
    L = P + max_new
    print(f"[7 asr] transcribe_batch of {B} clips, max_new_tokens {max_new}: "
          f"{wall:.2f} s wall, B2 launches {launches}; encode {enc_ms:.1f} ms "
          f"per batch of {B}; decode {dec_ms:.1f} ms for {L - 1} steps = "
          f"{(L - 1) / dec_ms * 1e3:.1f} steps/s, "
          f"{B * max_new / dec_ms * 1e3:.1f} generated tokens/s; generated "
          f"lengths {[len(t) for t in toks]} [{card}]", flush=True)
    wall_d, *prof = device_profile(
        torch, lambda: tdec.greedy_decode(cfg, asr.model, enc, prompt, P, max_new))
    print(f"[7 asr] profile of one decode ({L - 1} steps, B = {B}): wall "
          f"{wall_d:.1f} ms, {profile_line(*prof, wall_d)} [{card}]", flush=True)

    # teacher-forced: the cached steps against the full-sequence decoder
    ids = tdec.greedy_decode(cfg, asr.model, enc, prompt, P, max_new)
    with torch.inference_mode():
        ck, cv = tdec.precompute_cross_kv(asr.model, enc)
        nh, hd = cfg.num_heads, cfg.d_model // cfg.num_heads
        sk = torch.zeros((cfg.decoder_layers, B, L, nh, hd), device="cuda")
        sv = torch.zeros_like(sk)
        step = torch.stack([tdec.decoder_step(asr.model, ids[:, t], t, sk, sv,
                                              ck, cv) for t in range(L - 1)], 1)
        h = asr.model.decode(ids[:, : L - 1].long(), enc)
        full = h @ asr.model.decoder.embed_tokens.weight.T       # (B, L-1, V)
    err = ((step - full).abs().max() / full.abs().max()).item()
    abs_err = (step - full).abs().max().item()
    top2 = full.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    pred = full.argmax(-1)
    checked = mismatched = 0
    for b in range(B):
        for t in range(P - 1, L - 1):
            if margin[b, t] > 2 * abs_err:  # no error that small can flip it
                checked += 1
                mismatched += int(pred[b, t] != ids[b, t + 1])
            if int(ids[b, t + 1]) == cfg.eos_token_id:
                break  # later tokens are EOS padding, not argmaxes
    print(f"[7 asr] teacher-forced full decoder vs cached steps: logits "
          f"{err:.3e} of max|logit| (limit 1e-3); {checked} generated tokens "
          f"with top-2 margin > 2 x {abs_err:.2e}, {mismatched} differ "
          f"[{card}]", flush=True)
    check(err <= 1e-3, f"cached vs full logits {err}")
    check(mismatched == 0, f"{mismatched} tokens differ from the full decoder")
    return launches, dict(enc_ms=enc_ms, dec_ms=dec_ms, steps=L - 1,
                          tokens=B * max_new)


def write_wavs(d, pcm):
    os.makedirs(d)
    for name, w in pcm.items():
        with wave.open(os.path.join(d, f"{name}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(SR)
            f.writeframes(w.tobytes())


def phase_cli_whisper(torch, mf, ta, card):
    from mertools_tpu_torch.cli import extract_audio, main_asr

    rng = np.random.default_rng(2)
    pcm = {f"clip{i}": (rng.normal(size=int(s * SR)) * 3000).astype(np.int16)
           for i, s in enumerate((1.0, 4.0, 7.5, 31.0))}  # the last is cut to 30 s
    with tempfile.TemporaryDirectory() as d:
        audio = os.path.join(d, "audio")
        write_wavs(audio, pcm)
        before = mf.mel_power.launches
        t0 = time.perf_counter()
        extract_audio.main([
            "--model_name", "whisper-large-v2", "--audio_dir", audio,
            "--save_dir", os.path.join(d, "features"), "--random_init",
            "--transfer_dtype", "int16", "--feature_level", "UTTERANCE"])
        dt = time.perf_counter() - t0
        cli_launches = mf.mel_power.launches - before
        out_dir = os.path.join(d, "features", "whisper-large-v2-UTT")
        files = sorted(os.listdir(out_dir))
        check(files == [f"{n}.npy" for n in sorted(pcm)], f"CLI wrote {files}")
        feats = {n[:-4]: np.load(os.path.join(out_dir, n)) for n in files}

        csv_new = os.path.join(d, "new.csv")
        with open(csv_new, "w", encoding="utf-8") as f:
            f.write("name,sentence\nclip0,hello there\nclip1,你好\n")
        csv_chk = os.path.join(d, "check.csv")
        with open(csv_chk, "w", encoding="utf-8") as f:
            f.write("name,chinese\nclip1,你好吗\n")
        merged, refined = os.path.join(d, "merged.csv"), os.path.join(d, "refined.csv")
        main_asr.main(["merge", f"--new_path={csv_new}", f"--check_path={csv_chk}",
                       f"--merge_path={merged}"])
        main_asr.main(["punctuate", f"--old_path={csv_new}", f"--new_path={refined}"])
        with open(merged, encoding="utf-8") as f:
            merged_text = f.read()
        with open(refined, encoding="utf-8") as f:
            refined_text = f.read()
    check("你好吗" in merged_text and "hello there" in merged_text,
          f"merge wrote {merged_text!r}")
    check("hello there。" in refined_text, f"punctuate wrote {refined_text!r}")
    for n, f in feats.items():
        check(f.shape == (64,) and bool(np.isfinite(f).all()),
              f"CLI {n}: shape {f.shape} or non-finite")
    check(cli_launches >= 1, f"CLI: {cli_launches} B2 launches")
    cfg, params = extract_audio.load_whisper("whisper-large-v2", None, True)
    ref = ta.WhisperAudioExtractor(cfg, params, device="cuda").extract(
        {n: w.astype(np.float32) / 32768.0 for n, w in pcm.items()}, level="UTT")
    dd = rel_diff(feats, ref)
    print(f"[8 cli] extract_audio whisper-large-v2 --random_init wrote "
          f"{len(files)} UTT features (64,) in {dt:.1f} s incl. init, B2 "
          f"launches {cli_launches}; vs WhisperAudioExtractor f32: {dd:.3e} "
          f"(limit 1e-4); main_asr merge and punctuate wrote their CSVs "
          f"[{card}]", flush=True)
    check(dd <= 1e-4, f"CLI vs library {dd}")


# ------------------------------------------------------------ AffectGPT (B3)
B3_LENS = (512, 480, 448, 384, 320, 256, 160, 97)   # right padding, S = 512


def causal_pairs(lens, S: int) -> int:
    """(query, key) pairs the causal segment mask lets through in one head:
    the valid rows see the valid keys up to themselves, the pad rows the pad
    keys up to themselves."""
    return sum(n * (n + 1) // 2 + (S - n) * (S - n + 1) // 2 for n in lens)


def b3_inputs(torch, dtype, nh, nkv, hd, lens=B3_LENS, S=512, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lens)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(B, S, n, hd))
                                      .astype(np.float32)).to("cuda", dtype)
                     for n in (nh, nkv, nkv, nh))
    seg = torch.tensor([[1 if t < n else 0 for t in range(S)] for n in lens],
                       dtype=torch.int32, device="cuda")
    return q, k, v, seg, dout


def rel_err(torch, a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def b3_check(torch, fc, kind, nh, nkv, hd):
    """Kernel forward (O, lse) and backward (dQ, dK, dV through the autograd
    Function) against the plain version and autograd through it, on every
    row, pad rows included."""
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    q, k, v, seg, dout = b3_inputs(torch, dtype, nh, nkv, hd)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fc.flash_attention_causal(*qkv, seg)
    out.backward(dout)
    _, lse = fc.flash_attention_causal_fwd(q, k, v, seg)
    torch.cuda.synchronize()
    ref_in = [t.float().requires_grad_() for t in (q, k, v)]
    ref, ref_lse = fc.causal_attention_fwd_ref(*ref_in, seg)
    ref.backward(dout.float())
    errs = {"out": rel_err(torch, out, ref),
            "lse": (lse - ref_lse).abs().max().item()}
    errs.update({f"d{n}": rel_err(torch, a.grad, b.grad)
                 for n, a, b in zip("qkv", qkv, ref_in)})
    fwd_tol, grad_tol = B3_TOL[kind]
    check(bool(torch.isfinite(out).all()), f"B3 {kind} hd {hd}: non-finite output")
    check(errs["out"] <= fwd_tol, f"B3 {kind} hd {hd}: out {errs['out']}")
    check(errs["lse"] <= LSE_TOL, f"B3 {kind} hd {hd}: lse {errs['lse']}")
    for n in ("dq", "dk", "dv"):
        check(errs[n] <= grad_tol, f"B3 {kind} hd {hd}: {n} {errs[n]}")
    return errs


def phase_b3(torch, fc, card):
    """Kernel B3 (four kernels) against its plain version at TinyLlama's
    attention (B 8, S 512, nh 32, nkv 4, hd 64, ragged right padding), fp32
    and bf16, plus hd 128 at nh 28 (Qwen2.5-7B); the backward kernels
    bit-equal across two launches; device times of each kernel, of B3's
    backward and fwd+bwd, of the plain versions and of the yardsticks (SDPA
    forward, backward alone and fwd+bwd; ``torch.linalg.vecdot`` for di),
    then the same without the plain versions at B 4 x S 1024."""
    for kind in ("fp32", "bf16"):
        for nh, nkv, hd in ((32, 4, 64), (28, 4, 128)):
            e = b3_check(torch, fc, kind, nh, nkv, hd)
            print(f"[9 b3] {kind} B=8 S=512 nh={nh} nkv={nkv} hd={hd} lens="
                  f"{list(B3_LENS)}: out {e['out']:.3e}, dq {e['dq']:.3e}, dk "
                  f"{e['dk']:.3e}, dv {e['dv']:.3e} of max|ref| (limits "
                  f"{B3_TOL[kind]}), lse {e['lse']:.3e} abs (limit {LSE_TOL}) "
                  f"[{card}]", flush=True)

    # each kernel against its own plain version on the same inputs, bf16,
    # at the training shape, and the backward kernels bit for bit against a
    # second launch (the group's dK/dV sum has a fixed order)
    nh, nkv, hd, S = 32, 4, 64, 512
    q, k, v, seg, dout = b3_inputs(torch, torch.bfloat16, nh, nkv, hd)
    B = q.shape[0]
    out, lse = fc.flash_attention_causal_fwd(q, k, v, seg)
    di = fc.flash_attention_causal_bwd_prep(out, dout)
    dk, dv = fc.flash_attention_causal_bwd_dkv(q, k, v, seg, dout, lse, di)
    dq = fc.flash_attention_causal_bwd_dq(q, k, v, seg, dout, lse, di)
    di2 = fc.flash_attention_causal_bwd_prep(out, dout)
    dk2, dv2 = fc.flash_attention_causal_bwd_dkv(q, k, v, seg, dout, lse, di)
    dq2 = fc.flash_attention_causal_bwd_dq(q, k, v, seg, dout, lse, di)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(a, b)) for a, b in
              ((di, di2), (dk, dk2), (dv, dv2), (dq, dq2))),
          "B3 di / dkv / dq: two launches on the same inputs differ")
    r_out, _ = fc.causal_attention_fwd_ref(q, k, v, seg)
    r_di = fc.bwd_prep_ref(out, dout)
    r_dk, r_dv = fc.bwd_dkv_ref(q, k, v, seg, dout, lse, di)
    r_dq = fc.bwd_dq_ref(q, k, v, seg, dout, lse, di)
    vs_plain = {"fwd": [(out, r_out)], "prep": [(di, r_di)],
                "dkv": [(dk, r_dk), (dv, r_dv)], "dq": [(dq, r_dq)]}
    err = {n: max((a.float() - b.float()).abs().max().item() for a, b in ab)
           for n, ab in vs_plain.items()}
    rel = {n: max(rel_err(torch, a, b) for a, b in ab)
           for n, ab in vs_plain.items()}
    for n, r in rel.items():
        check(r <= B3_KERNEL_TOL[n], f"B3 {n} vs its plain version: {r} of "
              f"max|ref| > {B3_KERNEL_TOL[n]}")
    del di2, dk2, dv2, dq2, r_out, r_di, r_dk, r_dv, r_dq

    med = b3_times(torch, fc, B3_LENS, S, plain=True)
    # bytes: every input read once, every output written once; operations:
    # the products over the pairs this data's mask lets through
    pairs = causal_pairs(B3_LENS, S) * nh
    big, small = B * S * nh * hd * 2, B * S * nkv * hd * 2   # bf16 tensors
    rows, segb = B * nh * S * 4, B * S * 4                   # fp32 rows, seg
    work = {"fwd": (2 * big + 2 * small + segb + rows, 4.0 * hd * pairs, "bf16"),
            "prep": (2 * big + rows, 2.0 * B * S * nh * hd, "fp32"),
            "dkv": (2 * big + 4 * small + segb + 2 * rows, 8.0 * hd * pairs, "bf16"),
            "dq": (3 * big + 2 * small + segb + 2 * rows, 6.0 * hd * pairs, "bf16")}
    library = {"fwd": med["sdpa_fwd"], "prep": med["vecdot"]}
    res = {}
    for n, (nb, fl, kind) in work.items():
        b_ms, b_by = bound(nb, fl, kind)
        res[n] = dict(max_abs_err=err[n], ms=med[n], plain_ms=med[f"plain_{n}"],
                      library_ms=library.get(n), bound_ms=b_ms, bound_by=b_by)
        print(f"[9 b3] {n}: kernel {med[n]:.4f} ms, plain {med[f'plain_{n}']:.4f} "
              f"ms, library {library.get(n) or float('nan'):.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by} ({nb / 1e6:.1f} MB, {fl / 1e9:.2f} GFLOP; "
              f"the kernel at {b_ms / med[n]:.3f} of it), "
              f"max_abs_err vs plain {err[n]:.3e} = {rel[n]:.3e} of max|ref| "
              f"(limit {B3_KERNEL_TOL[n]}) [{card}]", flush=True)
    print(f"[9 b3] backward kernels bit-equal across two launches (di, dq, dk, dv) "
          f"[{card}]", flush=True)
    b3_line(med, f"B=8 S=512 lens={list(B3_LENS)}", card)
    print(f"[9 b3] plain fwd+bwd {med['plain_fwd_bwd']:.4f} ms [{card}]", flush=True)
    # the S 1024 training shape: the causal walk twice as deep
    b3_line(b3_times(torch, fc, (1024,) * 4, 1024, plain=False),
            "B=4 S=1024 full lengths", card)
    return res


def b3_times(torch, fc, lens, S: int, plain: bool) -> dict:
    """Device-only CUDA-event medians of 10, in turns, bf16 at nh 32, nkv 4,
    hd 64: each B3 kernel; B3's and SDPA's backward alone (the graph's
    forward ran outside the window) and fwd+bwd; SDPA's forward with the
    same boolean mask (kv repeated to 32 heads); di's one-call yardstick
    ``torch.linalg.vecdot``; with ``plain``, the plain versions."""
    nh, nkv, hd = 32, 4, 64
    q, k, v, seg, dout = b3_inputs(torch, torch.bfloat16, nh, nkv, hd, lens=lens, S=S)
    out, lse = fc.flash_attention_causal_fwd(q, k, v, seg)
    di = fc.flash_attention_causal_bwd_prep(out, dout)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (t.transpose(1, 2).repeat_interleave(nh // nkv, 1).contiguous()
              for t in (k, v))
    qhg, khg, vhg = (t.clone().requires_grad_() for t in (qh, kh, vh))
    mask = ((seg[:, :, None] == seg[:, None, :])
            & torch.ones(S, S, dtype=torch.bool, device="cuda").tril())[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    doh = dout.transpose(1, 2).contiguous()

    def fwd_bwd(f, ts, d):
        for t in ts:
            t.grad = None
        f().backward(d)

    def bwd(o, ts, d):
        for t in ts:
            t.grad = None
        o.backward(d, retain_graph=True)

    o_b3 = fc.flash_attention_causal(qg, kg, vg, seg)
    o_sdpa = sdpa(qhg, khg, vhg, attn_mask=mask)
    runs = {
        "fwd": lambda: fc.flash_attention_causal_fwd(q, k, v, seg),
        "prep": lambda: fc.flash_attention_causal_bwd_prep(out, dout),
        "dkv": lambda: fc.flash_attention_causal_bwd_dkv(q, k, v, seg, dout, lse, di),
        "dq": lambda: fc.flash_attention_causal_bwd_dq(q, k, v, seg, dout, lse, di),
        "bwd": lambda: bwd(o_b3, (qg, kg, vg), dout),
        "fwd_bwd": lambda: fwd_bwd(
            lambda: fc.flash_attention_causal(qg, kg, vg, seg), (qg, kg, vg), dout),
        "vecdot": lambda: torch.linalg.vecdot(out, dout, dim=-1),
        "sdpa_fwd": lambda: sdpa(qh, kh, vh, attn_mask=mask),
        "sdpa_bwd": lambda: bwd(o_sdpa, (qhg, khg, vhg), doh),
        "sdpa_fwd_bwd": lambda: fwd_bwd(
            lambda: sdpa(qhg, khg, vhg, attn_mask=mask), (qhg, khg, vhg), doh),
    }
    if plain:
        runs.update({
            "plain_fwd": lambda: fc.causal_attention_fwd_ref(q, k, v, seg),
            "plain_prep": lambda: fc.bwd_prep_ref(out, dout),
            "plain_dkv": lambda: fc.bwd_dkv_ref(q, k, v, seg, dout, lse, di),
            "plain_dq": lambda: fc.bwd_dq_ref(q, k, v, seg, dout, lse, di),
            "plain_fwd_bwd": lambda: fwd_bwd(
                lambda: fc.causal_attention_ref(qg, kg, vg, seg), (qg, kg, vg), dout)})
    for f in runs.values():
        f()
    times = {n: [] for n in runs}
    for _ in range(10):  # in turns, so drift hits all alike
        for n, f in runs.items():
            times[n] += cuda_ms(torch, f, reps=1, device_only=True)
    return {n: float(np.median(t)) for n, t in times.items()}


def b3_line(med: dict, shape: str, card: str) -> None:
    print(f"[9 b3] bf16 {shape} nh=32 nkv=4 hd=64 (device ms, median of 10): "
          f"fwd {med['fwd']:.4f}, di {med['prep']:.4f}, dkv {med['dkv']:.4f}, dq "
          f"{med['dq']:.4f}; backward di+dkv+dq {med['prep'] + med['dkv'] + med['dq']:.4f},"
          f" autograd backward alone {med['bwd']:.4f}, fwd+bwd {med['fwd_bwd']:.4f}; "
          f"SDPA with the same boolean mask (kv repeated to 32 heads) fwd "
          f"{med['sdpa_fwd']:.4f}, backward alone {med['sdpa_bwd']:.4f}, fwd+bwd "
          f"{med['sdpa_fwd_bwd']:.4f}; di as torch.linalg.vecdot {med['vecdot']:.4f} "
          f"[{card}]", flush=True)


def train_config(ta, tl, tq, flash: bool, layers: int = 22):
    """bench.py's mllm_train model (bench.py:585-599): TinyLlama-1.1B geometry
    (vocab 32000, hidden 2048, 22 layers, 32 heads, 4 KV heads, FFN 5632),
    LoRA r 16 on all seven projections, two 2-layer Q-Formers at width 768
    with 32 and 8 queries, video and audio dims 1024, loss_chunk 128."""
    llm = tl.LLMConfig(vocab_size=32000, hidden_size=2048, num_layers=layers,
                       num_heads=32, num_kv_heads=4, intermediate_size=5632,
                       lora_r=16, use_flash_attention=flash)
    qf = dict(hidden_size=768, num_layers=2, num_heads=12, intermediate_size=3072)
    return ta.AffectGPTConfig(
        llm=llm, video_qformer=tq.QFormerConfig(num_queries=32, **qf),
        audio_qformer=tq.QFormerConfig(num_queries=8, **qf), video_dim=1024,
        audio_dim=1024, max_video_frames=8, max_audio_frames=8, loss_chunk=128)


def train_batch(nav: int, lens=B3_LENS, S: int = 512, seed: int = 2):
    """bench.py's batch (seed 2, AV block spliced at 1, answer tokens after
    it), with the rows right-padded to ``lens``: pads carry mask 0 and
    label -100."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    ids = rng.integers(1, 32000, size=(B, S)).astype(np.int32)
    ids[:, 1: 1 + nav] = 0
    mask = np.zeros((B, S), np.int32)
    labels = np.full((B, S), -100, np.int64)
    for b, n in enumerate(lens):
        mask[b, :n] = 1
        labels[b, 1 + nav: n] = rng.integers(0, 32000, size=n - 1 - nav)
    return {"video_feats": rng.normal(size=(B, 8, 1024)).astype(np.float32),
            "audio_feats": rng.normal(size=(B, 8, 1024)).astype(np.float32),
            "input_ids": ids, "splice_start": np.full(B, 1, np.int32),
            "attention_mask": mask, "labels": labels}


def set_flash(tl, model, on: bool) -> None:
    """Switch every LLM module of ``model`` between kernel B3 and the eager
    attention, keeping the weights."""
    for m in model.modules():
        if isinstance(getattr(m, "cfg", None), tl.LLMConfig):
            m.cfg = dataclasses.replace(m.cfg, use_flash_attention=on)


LORA_GRADS = tuple(f"llm.layers.0.self_attn.{p}.lora_B"
                   for p in ("q_proj", "k_proj", "v_proj"))


B3_WRAPPERS = ("flash_attention_causal_fwd", "flash_attention_causal_bwd_prep",
               "flash_attention_causal_bwd_dkv", "flash_attention_causal_bwd_dq")


def phase_train(torch, fc, ta, tl, tq, tr, card):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = train_config(ta, tl, tq, flash=True)
    t0 = time.perf_counter()
    model = ta.build(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch = train_batch(model.num_av_tokens)
    B, S = batch["input_ids"].shape
    steps = 10
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    rcfg = tr.RunnerConfig(max_epoch=1, iters_per_epoch=steps + 2, batch_size=B,
                           warmup_steps=1, init_lr=5e-4, min_lr=1e-4,
                           compute_dtype="bf16", output_dir=out_dir)
    runner = tr.Runner(rcfg, model)
    n_train = sum(p.numel() for p in runner.params)
    start = {n: p.detach().clone() for n, p in model.named_parameters()
             if p.requires_grad}
    print(f"[10 train] AffectGPT, TinyLlama-1.1B geometry + 2 Q-Formers, random "
          f"init on the card ({n_params / 1e6:.1f} M params, {n_train / 1e6:.2f} M "
          f"trainable in fp32, the frozen base in bf16) {init_s:.1f} s [{card}]",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    losses = [runner.train_step(batch)]   # warm-up step
    torch.cuda.synchronize()
    after1 = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    # the main path's run: the counts start at 0 here and are read right after
    for name in B3_WRAPPERS:
        getattr(fc, name).launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(runner.train_step(batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(fc, name).launches for name in B3_WRAPPERS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [x.item() for x in losses]
    step_ms = wall / steps * 1e3
    L = cfg.llm.num_layers
    print(f"[10 train] B={B} S={S} (valid lengths {list(B3_LENS)}), bf16, flash "
          f"(B3): {steps} steps in {wall:.3f} s = {step_ms:.1f} ms/step, "
          f"{B * S * steps / wall:.0f} tokens/s ({sum(B3_LENS) * steps / wall:.0f} "
          f"valid tokens/s); peak memory {peak_gb:.2f} GB; B3 launches "
          f"{launches} for {steps} steps x {L} layers [{card}]", flush=True)
    print(f"[10 train] loss trajectory (warm-up step first): "
          f"{[round(x, 4) for x in losses]} [{card}]", flush=True)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(n == steps * L for n in launches.values()),
          f"B3 launches {launches}, want {steps * L} each")

    wall_p, *prof = device_profile(torch, lambda: runner.train_step(batch))
    print(f"[10 train] profile of one step: wall {wall_p:.1f} ms under the "
          f"profiler ({step_ms:.1f} ms unprofiled), {profile_line(*prof, step_ms)} "
          f"(idle of the unprofiled step) [{card}]", flush=True)

    # executed FLOP per step: torch's counter over the aten ops (no dW is
    # computed for the frozen base, so none is counted) plus B3's products,
    # which it cannot see: forward 2 and backward 5 products over the pairs
    # the mask lets through (the kernels execute 7: dkv and dq each
    # recompute S and dP)
    with FlopCounterMode(display=False) as counter:
        runner.train_step(batch)
    hd, nh = cfg.llm.head_dim, cfg.llm.num_heads
    attn = L * 2.0 * hd * nh * causal_pairs(B3_LENS, S) * (2 + 5)
    flops = counter.get_total_flops() + attn
    print(f"[10 train] executed work per step {flops / 1e12:.3f} TFLOP "
          f"({counter.get_total_flops() / 1e12:.3f} in matmuls torch counts, "
          f"{attn / 1e12:.3f} in B3): {flops / step_ms / 1e9:.1f} TFLOP/s, "
          f"{flops / step_ms / 1e9 / (PEAK['bf16'] / 1e12):.3f} of the bf16 "
          f"peak [{card}]", flush=True)

    # the LoRA gradients of layer 0's attention projections after the first
    # step, flash against eager: they pass through every layer's attention
    # backward (dQ, dK, dV), which the loss alone hardly sees at random init
    def lora_grads(on: bool) -> dict:
        set_flash(tl, model, on)
        model.zero_grad(set_to_none=True)
        loss, _ = model(runner.place(batch))
        loss.backward()
        got = {n: p.grad.float().clone() for n, p in model.named_parameters()
               if n in LORA_GRADS}
        model.zero_grad(set_to_none=True)
        return got

    def load(weights: dict) -> None:
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in weights:
                    p.copy_(weights[n])

    load(after1)
    g_flash, g_eager = lora_grads(True), lora_grads(False)
    d_grad = {n.split(".")[-2]: rel_err(torch, g_flash[n], g_eager[n])
              for n in LORA_GRADS}
    print(f"[10 train] LoRA gradients of layer 0 after the first step, flash vs "
          f"eager: {d_grad} of max|eager| (limit {LORA_GRAD_TOL}) [{card}]",
          flush=True)
    check(max(d_grad.values()) <= LORA_GRAD_TOL, f"flash vs eager LoRA grads {d_grad}")

    # which bf16 path is the farther from an fp32 gradient: a float32 copy of
    # the model at the same weights, no AMP, eager attention, the same batch
    ref32 = copy.deepcopy(model).float()
    set_flash(tl, ref32, False)
    loss32, _ = ref32({k: torch.from_numpy(np.asarray(v)).to("cuda")
                       for k, v in batch.items()})
    loss32.backward()
    g32 = {n: p.grad.clone() for n, p in ref32.named_parameters() if n in LORA_GRADS}
    del ref32, loss32
    torch.cuda.empty_cache()
    e_flash = max(rel_err(torch, g_flash[n], g32[n]) for n in LORA_GRADS)
    e_eager = max(rel_err(torch, g_eager[n], g32[n]) for n in LORA_GRADS)
    check(all(bool(torch.isfinite(g).all()) for g in g32.values()),
          "fp32 eager LoRA gradients not finite")
    print(f"[10 train] LoRA gradients of layer 0 against an fp32 eager copy of "
          f"the model (same weights and batch): bf16 flash {e_flash:.3e}, bf16 "
          f"eager {e_eager:.3e} of max|fp32| (worst of q, k, v); flash / eager "
          f"{e_flash / e_eager:.2f}: "
          f"{'rounding (<= 2)' if e_flash <= 2 * e_eager else 'flash farther: a B3 backward fault'}"
          f" [{card}]", flush=True)
    del g_flash, g_eager, g32, after1

    # the same steps with the eager attention, from the same weights
    load(start)
    set_flash(tl, model, False)
    eager = tr.Runner(rcfg, model)
    e_losses = [eager.train_step(batch).item() for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eager.train_step(batch)
    torch.cuda.synchronize()
    e_ms = (time.perf_counter() - t0) / 3 * 1e3
    d = [abs(a - b) / abs(b) for a, b in zip(losses[:2], e_losses)]
    print(f"[10 train] eager attention: {e_ms:.1f} ms/step, {B * S / e_ms * 1e3:.0f} "
          f"tokens/s; loss flash vs eager (valid rows) at the first step "
          f"{losses[0]:.6f} vs {e_losses[0]:.6f} ({d[0]:.2e}), after it "
          f"{losses[1]:.6f} vs {e_losses[1]:.6f} ({d[1]:.2e}) (limit "
          f"{LLM_FLASH_TOL}) [{card}]", flush=True)
    check(max(d) <= LLM_FLASH_TOL, f"flash vs eager loss {d}")
    del model, runner, eager, start
    torch.cuda.empty_cache()

    # fp32: the card (B3's FMA kernels) against the CPU (its plain version)
    # at full width with 2 LLM layers of the same weights
    cfg2 = train_config(ta, tl, tq, flash=True, layers=2)
    cpu = ta.build(cfg2, "cpu", seed=1)
    gpu = ta.AffectGPT(cfg2, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    small = train_batch(cpu.num_av_tokens, lens=(128, 77), S=128, seed=4)
    res = {}
    for dev, m in (("cpu", cpu), ("cuda", gpu)):
        ta.set_trainable(m)
        loss, _ = m({k: torch.from_numpy(v).to(dev) for k, v in small.items()})
        loss.backward()
        res[dev] = (loss.item(), {n: p.grad.cpu() for n, p in m.named_parameters()
                                  if p.grad is not None})
    names = ("llm.layers.1.self_attn.q_proj.lora_B", "video_qformer.ffn1_0.weight")
    d_loss = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    d_grad = {n: rel_err(torch, res["cuda"][1][n], res["cpu"][1][n]) for n in names}
    print(f"[10 train] fp32 card vs CPU (full width, 2 LLM layers, B=2 S=128): "
          f"loss {res['cuda'][0]:.6f} vs {res['cpu'][0]:.6f} ({d_loss:.2e}, limit "
          f"1e-4); gradients {d_grad} of max|cpu| (limit 1e-3) [{card}]", flush=True)
    check(d_loss <= 1e-4, f"fp32 card vs CPU loss {d_loss}")
    check(max(d_grad.values()) <= 1e-3, f"fp32 card vs CPU gradients {d_grad}")
    return launches


def phase_cli_train(torch, fc, card):
    """The training CLI on the card: its tiny LLM at width 256 has head dim
    64, so its attention runs kernel B3 without being asked."""
    from mertools_tpu_torch.cli import train_mllm

    rng = np.random.default_rng(3)
    names = [f"clip{i}" for i in range(12)]
    with tempfile.TemporaryDirectory() as d:
        for sub in ("face", "audio"):
            os.makedirs(os.path.join(d, sub))
            for n in names:
                np.save(os.path.join(d, sub, f"{n}.npy"), rng.normal(
                    size=(int(rng.integers(3, 9)), 1024)).astype(np.float32))
        with open(os.path.join(d, "openset.csv"), "w") as f:
            f.write("name,openset\n" + "".join(
                f"{n},\"['happy', 'surprised']\"\n" for n in names))
        with open(os.path.join(d, "reason.csv"), "w") as f:
            f.write("name,reason\n" + "".join(
                f"{n},the person smiles and raises the eyebrows\n" for n in names))
        with open(os.path.join(d, "subtitle.csv"), "w") as f:
            f.write("name,english\n" + "".join(f"{n},what a day\n" for n in names))
        cfg = os.path.join(d, "train.yaml")
        with open(cfg, "w") as f:
            f.write(f"""model:
  llm_checkpoint: tiny
  llm_hidden_size: 256
  vocab_size: 256
  lora_r: 4
  video_dim: 1024
  audio_dim: 1024
  fusion: attention
  multi_fusion_type: attention
datasets:
  openset_csv: {d}/openset.csv
  reason_csv: {d}/reason.csv
  subtitle_csv: {d}/subtitle.csv
  face_or_frame: multiface_audio_face_text
  video_feat_dir: {d}/face
  face_feat_dir: {d}/face
  audio_feat_dir: {d}/audio
  label_type: hybird
run:
  max_epoch: 2
  iters_per_epoch: 4
  batch_size: 4
  warmup_steps: 2
  max_len: 256
  valid_frac: 0.25
  amp: bf16
  output_dir: {d}/out
""")
        for name in B3_WRAPPERS:
            getattr(fc, name).launches = 0
        t0 = time.perf_counter()
        train_mllm.main([f"--config={cfg}"])
        train_mllm.main([f"--config={cfg}", "--options", "run.max_epoch=3",
                         f"run.resume_ckpt_path={d}/out/checkpoint_1"])
        dt = time.perf_counter() - t0
        launches = {name: getattr(fc, name).launches for name in B3_WRAPPERS}
        with open(os.path.join(d, "out", "log.txt")) as f:
            log = [json.loads(line) for line in f]
        made = sorted(os.listdir(os.path.join(d, "out")))
    check([e["epoch"] for e in log] == [0, 1, 2], f"log epochs {log}")
    check(all(math.isfinite(e["train_loss"]) for e in log),
          f"non-finite losses {log}")
    check(all(n > 0 for n in launches.values()), f"CLI B3 launches {launches}")
    for want in ("checkpoint_0", "checkpoint_1", "checkpoint_2", "checkpoint_best",
                 "model"):
        check(want in made, f"CLI wrote {made}")
    print(f"[11 cli] train_mllm (tiny LLM at width 256, head dim 64, "
          f"multiface_audio_face_text, attention fusion, bf16, 12 clips with a "
          f"25% validation split) 2 epochs, then resumed from checkpoint_1 for "
          f"epoch 2, on the card in {dt:.1f} s: train losses "
          f"{[(e['epoch'], round(e['train_loss'], 4)) for e in log]}; B3 "
          f"launches {launches}; wrote {made} [{card}]", flush=True)


# --------------------------------------------------- fusion trainer (phase 12)
# MER2023's published split sizes (train, test1, test2, test3) and the
# published widths of the features the MERBench recipe fuses
MER2023_SPLITS = {"train": 3373, "test1": 411, "test2": 412, "test3": 834}
FUSION_FEATURES = (("chinese-hubert-large-UTT", 1024),
                   ("chinese-macbert-large-UTT", 1024),
                   ("clip-vit-large-patch14-UTT", 768))
FUSION_TOL = 1e-4   # card vs CPU logits, max |card - cpu| / max |cpu|


def fusion_flags(features_root, label_path, save_root, feats, *extra):
    """``main_release`` flags for MER2023 with attention fusion on UTT
    features ``feats`` = (audio, text, video)."""
    return ["--dataset=MER2023", f"--audio_feature={feats[0]}",
            f"--text_feature={feats[1]}", f"--video_feature={feats[2]}",
            "--feat_type=utt", "--model=attention", "--seed=0",
            f"--features_root={features_root}", f"--label_path={label_path}",
            f"--save_root={save_root}", *extra]


def fusion_labels(rng, names: dict) -> tuple[dict, dict]:
    """Seeded label corpora for ``names[split]``: one of the 6 MER emotions
    a clip and a valence that follows it, with noise. Returns (corpora, the
    emotion indices a split)."""
    from mertools_tpu_torch.core.globals_mer import EMOS_MER

    corpora, emos = {}, {}
    for split, ns in names.items():
        emos[split] = rng.integers(0, 6, len(ns))
        vals = (emos[split] - 2.5) / 2.5 + 0.3 * rng.normal(size=len(ns))
        corpora[split] = {n: {"emo": EMOS_MER[e], "val": float(v)}
                          for n, e, v in zip(ns, emos[split], vals)}
    return corpora, emos


def fusion_card_vs_cpu(card_res, cpu_res, split: str) -> float:
    """max |card - cpu| / max |cpu| over a test split's fold-averaged
    emotion logits and valence predictions."""
    return max(float(np.abs(card_res.test_results[split][k]
                            - cpu_res.test_results[split][k]).max()
                     / np.abs(cpu_res.test_results[split][k]).max())
               for k in ("emoprobs", "valpreds"))


def phase_fusion_hubert(torch, card, dev: str = "cuda"):
    """12a: HuBERT-large UTT features from the extraction CLI, then the
    fusion trainer's CLI on them (the one feature as audio, text and video:
    "unimodal"), on the card and on the CPU."""
    from mertools_tpu_torch.cli import extract_audio, main_release
    from mertools_tpu_torch.core.globals_mer import feature_dir_name
    from mertools_tpu_torch.data import labels

    rng = np.random.default_rng(12)
    pcm = {f"clip{i:02d}": (rng.normal(size=int(s * SR)) * 3000).astype(np.int16)
           for i, s in enumerate(rng.uniform(2, 10, 40))}
    feat = feature_dir_name("chinese-hubert-large", "UTT")
    with tempfile.TemporaryDirectory() as d:
        write_wavs(os.path.join(d, "audio"), pcm)
        t0 = time.perf_counter()
        extract_audio.main([
            "--model_name", "chinese-hubert-large", "--audio_dir",
            os.path.join(d, "audio"), "--save_dir", os.path.join(d, "features"),
            "--random_init", "--encoder_size", "large", "--compute_dtype", "bf16",
            "--transfer_dtype", "int16", "--feature_level", "UTTERANCE",
            "--device", "cuda" if dev == "cuda" else "cpu"])
        t_extract = time.perf_counter() - t0
        names = sorted(pcm)
        corpora, _ = fusion_labels(rng, {"train": names[:30], "test1": names[30:]})
        labels.write_label_archive(os.path.join(d, "label.npz"), corpora)
        runs, files, secs = {}, {}, {}
        for leg, where in (("card", dev), ("cpu", "cpu")):
            save = os.path.join(d, f"saved_{leg}")
            t0 = time.perf_counter()
            runs[leg] = main_release.main(fusion_flags(
                os.path.join(d, "features"), os.path.join(d, "label.npz"), save,
                (feat,) * 3, "--hidden_dim=256", "--dropout=0", "--lr=1e-3",
                "--epochs=3", "--device", where))
            secs[leg] = time.perf_counter() - t0
            files[leg] = sorted(re.sub(r"_[0-9.]+\.npz$", "", f) for f in
                                os.listdir(os.path.join(f"{save}-unimodal", "result")))
    for leg, fs in files.items():
        check([f.split("_")[0] for f in fs] == ["cv", "test1"], f"{leg} wrote {fs}")
    got = runs["card"].test_results["test1"]["emoprobs"]
    check(got.shape == (10, 6) and bool(np.isfinite(got).all()),
          f"test1 logits {got.shape} or non-finite")
    d_cpu = fusion_card_vs_cpu(runs["card"], runs["cpu"], "test1")
    print(f"[12 fusion] a: extract_audio chinese-hubert-large --random_init "
          f"(bf16, int16 wire) wrote 40 UTT features (1024,) in {t_extract:.1f} s "
          f"incl. init; main_release MER2023 attention (unimodal, hidden 256, "
          f"dropout 0, 3 epochs, 5 folds of 30 train clips, test1 10 clips) "
          f"{secs['card']:.1f} s on the card, {secs['cpu']:.1f} s on the CPU; cv "
          f"{runs['card'].cv_str} (CPU {runs['cpu'].cv_str}); wrote {files['card']}; "
          f"test1 logits and valence, card vs CPU: {d_cpu:.3e} of max|cpu| "
          f"(limit {FUSION_TOL}) [{card}]", flush=True)
    # the names end in the metrics to 4 decimals, which the card's and the
    # CPU's rounding can move by one in the last place; the rest is equal
    stem = {leg: [re.sub(r"_f1:.*$", "", f) for f in fs] for leg, fs in files.items()}
    check(stem["card"] == stem["cpu"], f"card wrote {files['card']}, CPU {files['cpu']}")
    check(d_cpu <= FUSION_TOL, f"12a card vs CPU {d_cpu}")


def fusion_features(rng, emos, dim: int) -> np.ndarray:
    """(N, dim) class-separable features: a seeded centre a class plus unit
    noise."""
    centres = rng.normal(size=(6, dim)).astype(np.float32) * 0.3
    return centres[emos] + rng.normal(size=(len(emos), dim)).astype(np.float32)


def phase_fusion_mer2023(torch, card, dev: str = "cuda", splits=MER2023_SPLITS,
                         epochs: int = 10):
    """12b: ``main_release`` at MER2023's split sizes on seeded synthetic UTT
    features at the published widths, 5 folds; then one epoch of a fold
    under the profiler."""
    from mertools_tpu_torch.cli import main_release
    from mertools_tpu_torch.core.config import Args
    from mertools_tpu_torch.core.device import resolve_device
    from mertools_tpu_torch.data import feature_store, labels
    from mertools_tpu_torch.data.dataset import FeatureDataset, epoch_plan
    from mertools_tpu_torch.train import loop

    rng = np.random.default_rng(13)
    corpora, emos = fusion_labels(
        rng, {s: [f"{s}_{i:05d}" for i in range(n)] for s, n in splits.items()})
    names = [n for c in corpora.values() for n in c]
    all_emos = np.concatenate(list(emos.values()))
    feats = {f: fusion_features(rng, all_emos, dim) for f, dim in FUSION_FEATURES}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        for f, x in feats.items():
            for n, row in zip(names, x):
                feature_store.write_feature(os.path.join(d, "features", f), n, row)
        labels.write_label_archive(os.path.join(d, "label.npz"), corpora)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = main_release.main(fusion_flags(
            os.path.join(d, "features"), os.path.join(d, "label.npz"),
            os.path.join(d, "saved"), [f for f, _ in FUSION_FEATURES],
            "--hidden_dim=256", "--dropout=0.3", "--lr=1e-3", "--batch_size=32",
            f"--epochs={epochs}", "--device", dev))
        t_cli = time.perf_counter() - t0
        made = sorted(os.listdir(os.path.join(d, "saved-trimodal", "result")))
    n_train = splits["train"]
    per = n_train // 5      # kfold_indices: 4 chunks of `per`, the last the rest
    evals = [per] * 4 + [n_train - 4 * per]
    steps = sum(math.ceil((n_train - e) / 32) for e in evals) * epochs
    tests = {s: res.test_results[s] for s in splits if s != "train"}
    print(f"[12 fusion] b: main_release MER2023 attention on {n_train} train "
          f"clips and test1/2/3 of {splits['test1']}/{splits['test2']}/"
          f"{splits['test3']} (synthetic class-separable UTT features: "
          f"{', '.join(f'{f} ({dim})' for f, dim in FUSION_FEATURES)}; "
          f"{len(names)} clips x {sum(dim for _, dim in FUSION_FEATURES)} floats), "
          f"hidden 256, dropout 0.3, lr 1e-3, batch 32, {epochs} epochs, 5 "
          f"folds: cv WAF {res.cv['emofscore']:.4f}, accuracy "
          f"{res.cv['emoacc']:.4f}, valence MSE {res.cv['valmse']:.4f}; test WAF "
          f"{ {s: round(r['emofscore'], 4) for s, r in tests.items()} }; "
          f"run_cv {res.duration:.2f} s: {res.duration / 5:.3f} s a fold, "
          f"{res.duration / (5 * epochs):.4f} s an epoch, "
          f"{steps / res.duration:.1f} training steps/s ({steps} steps; eval, "
          f"tests and host metrics included); the CLI {t_cli:.1f} s with "
          f"reading; writing the store {t_write:.1f} s [{card}]", flush=True)
    check(res.cv["emofscore"] > 0.9, f"12b cv WAF {res.cv['emofscore']}")
    check(len(made) == 4, f"12b wrote {made}")

    # one epoch of a fold (train, eval, three tests, host metrics) under
    # the profiler, after one unprofiled epoch
    args = Args(model="attention", feat_type="utt", hidden_dim=256, dropout=0.3,
                lr=1e-3, l2=1e-5, grad_clip=-1.0, output_dim1=6, output_dim2=1)
    device = resolve_device(dev, fp32=True)
    split_of, start = {}, 0
    for s, n in splits.items():
        sl = slice(start, start + n)
        split_of[s] = FeatureDataset(
            names[sl], *(feats[f][sl] for f, _ in FUSION_FEATURES),
            emos[s].astype(np.int32),
            np.array([c["val"] for c in corpora[s].values()], np.float32))
        start += n
    train = loop.Split.upload(split_of["train"], device)
    tests_dev = {s: (loop.Split.upload(ds, device), epoch_plan(np.arange(len(ds)), 32))
                 for s, ds in split_of.items() if s != "train"}
    fold_rng = np.random.default_rng(0)
    idx = fold_rng.permutation(n_train)
    train_idx, eval_idx = idx[per:], idx[:per]
    sample = {k: v[:32] for k, v in split_of["train"].arrays().items()}
    model = loop.init_model(args, sample, torch.Generator().manual_seed(0)).to(device)
    opt = loop.ClippedAdam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device=device).manual_seed(0)

    def epoch():
        loop.run_epoch(model, opt, gen, train, epoch_plan(train_idx, 32, fold_rng),
                       epoch_plan(eval_idx, 32), tests_dev, True, True)

    epoch()
    if dev != "cuda":
        return res
    wall, *prof = device_profile(torch, epoch)
    n_eval = math.ceil(per / 32) + sum(math.ceil(n / 32) for s, n in splits.items()
                                       if s != "train")
    print(f"[12 fusion] b: profile of one epoch of a fold "
          f"({math.ceil(len(train_idx) / 32)} training steps, {n_eval} eval and "
          f"test batches, host metrics): wall {wall:.1f} ms, "
          f"{profile_line(*prof, wall)} [{card}]", flush=True)
    return res


def same_weights_check(torch, args, sets: dict, dev: str, rng, epochs: int = 2):
    """The card against the CPU where both start from the same weights (a
    fresh fold model, seed 0): every gradient of one training step on the
    first batch of ``sets["train"]``, then the test1 logits and valence of
    the model the card trained for ``epochs`` epochs (batch orders from
    ``rng``), evaluated on both. Returns the two max |card - cpu| /
    max |cpu|."""
    from mertools_tpu_torch.core.device import resolve_device
    from mertools_tpu_torch.data.dataset import epoch_plan
    from mertools_tpu_torch.train import loop

    n_train, n_test = len(sets["train"]), len(sets["test1"])
    devs = {"card": resolve_device(dev, fp32=True), "cpu": torch.device("cpu")}
    idx, mask = epoch_plan(np.arange(n_train), 32, np.random.default_rng(0))
    sample = {k: v[idx[0]] for k, v in sets["train"].arrays().items()}
    models = {"cpu": loop.init_model(args, sample, torch.Generator().manual_seed(0))}
    models["card"] = copy.deepcopy(models["cpu"]).to(devs["card"])
    data = {leg: {s: loop.Split.upload(ds, d) for s, ds in sets.items()}
            for leg, d in devs.items()}
    grads = {}
    for leg, m in models.items():
        b = torch.from_numpy(idx[0]).to(devs[leg])
        batch = {k: v.index_select(0, b) for k, v in data[leg]["train"].data.items()}
        loss, _, _ = loop.compute_loss(m.train(), batch, torch.from_numpy(mask[0]).to(devs[leg]),
                                       None, True, True)
        loss.backward()
        grads[leg] = {n: p.grad.cpu() for n, p in m.named_parameters() if p.grad is not None}
        m.zero_grad(set_to_none=True)
    d_grad = max(float((grads["card"][n] - g).abs().max() / g.abs().max())
                 for n, g in grads["cpu"].items())
    opt = loop.ClippedAdam(models["card"].parameters(), lr=1e-3)
    for _ in range(epochs):
        plan = epoch_plan(np.arange(n_train), 32, rng)
        loop.train_epoch(models["card"], opt, data["card"]["train"].data,
                         *(torch.from_numpy(x).to(devs["card"]) for x in plan),
                         None, True, True)
    models["cpu"].load_state_dict(models["card"].state_dict())
    test_plan = epoch_plan(np.arange(n_test), 32)
    logits = {leg: [t.cpu() for t in loop.eval_epoch(
        m, data[leg]["test1"].data, *(torch.from_numpy(x).to(devs[leg]) for x in test_plan),
        True, True)[1:]] for leg, m in models.items()}
    d_eval = max(float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(logits["card"], logits["cpu"]))
    return d_grad, d_eval


def phase_fusion_frames(torch, card, dev: str = "cuda", n_train: int = 200,
                        n_test: int = 40):
    """12c: frm_align with LSTM encoders (cuDNN on the card): ``run_cv`` on
    ragged frame-level features at the published widths, on the card and on
    the CPU.

    Two trainings agree only as far as Adam's first steps let rounding
    grow: an element whose gradient is within rounding of 0 moves by up to
    lr either way. So the card is held to the CPU where both start from the
    same weights — every gradient of a training step, and the test logits of
    a model the card trained for 2 epochs — and the script prints how far
    the two ``run_cv`` runs drift apart, beside how far the CPU's own run
    drifts when 1e-7 of each gradient's max is added as noise."""
    from mertools_tpu_torch.core.config import Args
    from mertools_tpu_torch.data.dataset import FeatureDataset
    from mertools_tpu_torch.train import loop

    rng = np.random.default_rng(14)

    def ragged(n):
        spans = ((1024, 100, 500), (1024, 16, 64), (768, 50, 250))  # a, t, v
        return [[rng.normal(size=(int(rng.integers(lo, hi + 1)), dim)).astype(np.float32)
                 for _ in range(n)] for dim, lo, hi in spans]

    sets = {}
    for split, n in (("train", n_train), ("test1", n_test)):
        emos = rng.integers(0, 6, n)
        sets[split] = FeatureDataset.from_raw(
            [f"{split}{i}" for i in range(n)], emos, (emos - 2.5) / 2.5, *ragged(n),
            feat_type="frm_align", feat_scale=6)
    args = Args(model="attention", feat_type="frm_align", hidden_dim=128, dropout=0.0,
                lr=1e-3, l2=1e-5, grad_clip=-1.0, batch_size=32, epochs=2,
                num_folder=2, output_dim1=6, output_dim2=1, metric_name="emoval")
    runs = {leg: loop.run_cv(args, sets["train"], {"test1": sets["test1"]},
                             seed=0, verbose=False, device=where)
            for leg, where in (("card", dev), ("cpu", "cpu"))}
    check(bool(np.isfinite(runs["card"].test_results["test1"]["emoprobs"]).all()),
          "12c non-finite logits")
    noise = torch.Generator().manual_seed(1)

    clipped_adam = loop.ClippedAdam

    class NoisyAdam(clipped_adam):
        def step(self):
            for p in self.params:
                p.grad += 1e-7 * p.grad.abs().max() * torch.randn(p.grad.shape,
                                                                  generator=noise)
            super().step()

    loop.ClippedAdam = NoisyAdam  # run_cv builds each fold's optimizer by name
    try:
        noisy = loop.run_cv(args, sets["train"], {"test1": sets["test1"]}, seed=0,
                            verbose=False, device="cpu")
    finally:
        loop.ClippedAdam = clipped_adam
    d_runs = fusion_card_vs_cpu(runs["card"], runs["cpu"], "test1")
    d_noise = fusion_card_vs_cpu(noisy, runs["cpu"], "test1")

    d_grad, d_eval = same_weights_check(torch, args, sets, dev, rng)
    shape = sets["train"].audios.shape
    print(f"[12 fusion] c: run_cv frm_align (LSTM encoders, feat_scale 6, "
          f"audio 100-500 / text 16-64 / video 50-250 frames aligned to the "
          f"text: train {shape}), hidden 128, dropout 0, 2 folds x 2 epochs: "
          f"{runs['card'].duration / 4:.3f} s an epoch on the card, "
          f"{runs['cpu'].duration / 4:.3f} s on the CPU; best epochs "
          f"{runs['card'].best_epochs} (CPU {runs['cpu'].best_epochs}); card vs "
          f"CPU from the same weights: a step's gradients {d_grad:.3e}, test1 "
          f"logits and valence of the card's model after 2 epochs {d_eval:.3e} "
          f"of max|cpu| (limit {FUSION_TOL}); the two run_cv runs' test1 "
          f"outputs {d_runs:.3e} apart, the CPU's run against itself with "
          f"1e-7 gradient noise {d_noise:.3e} [{card}]", flush=True)
    check(d_grad <= FUSION_TOL, f"12c card vs CPU gradients {d_grad}")
    check(d_eval <= FUSION_TOL, f"12c card vs CPU test logits {d_eval}")


# ------------------------------------------ text, vision, trimodal (13-15)
# worst clip's max|a - b| / max|b| (PERF.md §2): how many times as far
# from fp32 the bf16+B1 route may lie as the inline bf16 route does; each
# bf16 route from fp32; fp32+B1 from fp32; card vs CPU in fp32
FEATURE_TOL = {"flash_spread": 1.25, "bf16": 3e-2, "fp32_flash": 1e-4, "cpu": 1e-3}
MODES = {"fp32": {}, "fp32_flash": dict(flash=True), "bf16": dict(compute_dtype="bf16"),
         "bf16_flash": dict(compute_dtype="bf16", flash=True)}


class CharTokenizer:
    """A character-level stand-in for chinese-macbert-large's BertTokenizer
    (no tokenizer file is in the repository, and the card's machine has no
    ``transformers``): [CLS] + one id a CJK character + [SEP], every id
    inside the 21128-entry vocabulary; ``decode`` joins the characters with
    spaces, as BertTokenizer's does, so ``find_token_span`` finds (1, -1)."""

    CLS, SEP, FIRST_ID, FIRST_CHAR, N_CHARS = 101, 102, 672, 0x4E00, 21128 - 672

    def __call__(self, text: str) -> dict:
        return {"input_ids": [self.CLS] + [ord(c) - self.FIRST_CHAR + self.FIRST_ID
                                           for c in text] + [self.SEP]}

    def decode(self, ids) -> str:
        names = {self.CLS: "[CLS]", self.SEP: "[SEP]"}
        return " ".join(names.get(i) or chr(i - self.FIRST_ID + self.FIRST_CHAR)
                        for i in ids)

    @classmethod
    def sentence(cls, rng, n_tokens: int) -> str:
        """A seeded sentence that tokenizes to ``n_tokens`` ids."""
        return "".join(chr(cls.FIRST_CHAR + int(i))
                       for i in rng.integers(0, cls.N_CHARS, n_tokens - 2))


def text_corpus(rng) -> dict:
    """Phase 13's sentences as token ids: 504 of 8-96 tokens (log-uniform,
    so the short buckets fill whole batches) and 16 long ones, 8 of 200-256
    and 8 of 257-510 tokens. 520 = 8 batches of 64 and one of 8, so a batch
    boundary falls among the long ones and every bucket of
    ``DEFAULT_TOKEN_BUCKETS`` holds a batch."""
    lens = np.round(np.exp(rng.uniform(np.log(8), np.log(96), 504))).astype(int)
    lens = [*lens, *rng.integers(200, 257, 8), *rng.integers(257, 511, 8)]
    tok = CharTokenizer()
    return {f"s{i:03d}": tok(CharTokenizer.sentence(rng, int(n)))["input_ids"]
            for i, n in enumerate(lens)}


def text_batches(token_ids: dict, buckets, batch: int = 64) -> list:
    """(bucket, key lengths) of each batch ``TextExtractor.extract`` forms
    from ``token_ids``: sentences sorted by length, ``batch`` at a time,
    each batch padded to the first bucket that holds its longest (the last
    bucket cuts), so B1 sees (rows, bucket) and these key lengths."""
    lens = sorted(len(t) for t in token_ids.values())
    out = []
    for i in range(0, len(lens), batch):
        part = lens[i: i + batch]
        bucket = next((b for b in buckets if part[-1] <= b), buckets[-1])
        out.append((bucket, [min(n, bucket) for n in part]))
    return out


def feature_gates(d: dict, label: str) -> None:
    """Phases 13-14's gates on ``d[a, b, level]``, the worst clip's max|a -
    b| / max|b| between modes: on UTT and FRA the bf16+B1 route lies at
    most ``flash_spread`` times as far from fp32 as the inline bf16 route
    (a fault in B1 moves only the first), and fp32+B1 within ``fp32_flash``
    of fp32 (B1 against the inline attention through the whole encoder);
    on UTT both bf16 routes within ``bf16`` of fp32. bf16+B1 vs bf16 is
    printed, not gated: two bf16 routes that round the attention apart lie
    as far apart as each lies from fp32 (PERF.md §6)."""
    for lv in ("UTT", "FRA"):
        lim = FEATURE_TOL["flash_spread"] * d["bf16", "fp32", lv]
        check(d["bf16_flash", "fp32", lv] <= lim,
              f"{label} {lv} bf16+B1 vs fp32 {d['bf16_flash', 'fp32', lv]} > {lim}")
        check(d["fp32_flash", "fp32", lv] <= FEATURE_TOL["fp32_flash"],
              f"{label} {lv} fp32+B1 vs fp32 {d['fp32_flash', 'fp32', lv]}")
    for mode in ("bf16", "bf16_flash"):
        check(d[mode, "fp32", "UTT"] <= FEATURE_TOL["bf16"],
              f"{label} UTT {mode} vs fp32 {d[mode, 'fp32', 'UTT']}")


def layer_prefix_sd(params: dict, layers_key: str, n: int) -> dict:
    """The state dict of the first ``n`` layers (and everything outside
    ``layers_key``), on the CPU."""
    def keep(k):
        if layers_key not in k:
            return True
        return int(k.split(layers_key)[1].split(".")[0]) < n
    return {k: v.cpu() for k, v in params.items() if keep(k)}


def run_modes(torch, fa, make, data: dict, warm: dict, n_batches: int,
              layers: int, label: str, card: str, dev: str):
    """The main path of phases 13 and 14: each mode's extractor (``make(
    **kw)``) warmed on ``warm``, then, with B1's count set to 0 just before,
    UTT and FRA over ``data``. Returns (extractors, outputs by (mode,
    level), seconds, launches by mode)."""
    exs = {m: make(**kw) for m, kw in MODES.items()}
    for ex in exs.values():
        ex.extract(warm, level="UTT")
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    fa.flash_attention.launches = 0
    outs, secs, launches = {}, {}, {}
    for mode, ex in exs.items():
        before = fa.flash_attention.launches
        for level in ("UTT", "FRA"):
            t0 = time.perf_counter()
            outs[mode, level] = ex.extract(data, level=level)
            sync()
            secs[mode, level] = time.perf_counter() - t0
        launches[mode] = fa.flash_attention.launches - before
    for mode, n in launches.items():
        want = 2 * layers * n_batches if "flash" in mode else 0
        check(n == want, f"{label} {mode}: {n} B1 launches, want {want}")
    d = {(a, b, lv): rel_diff(outs[a, lv], outs[b, lv]) for lv in ("UTT", "FRA")
         for a, b in (("bf16_flash", "bf16"), ("bf16", "fp32"),
                      ("bf16_flash", "fp32"), ("fp32_flash", "fp32"))}
    for lv in ("UTT", "FRA"):
        print(f"[{label}] {lv}, worst clip's max|a - b| / max|b|: bf16+B1 vs "
              f"bf16 {d['bf16_flash', 'bf16', lv]:.3e}, bf16 vs fp32 "
              f"{d['bf16', 'fp32', lv]:.3e}, bf16+B1 vs fp32 "
              f"{d['bf16_flash', 'fp32', lv]:.3e}, fp32+B1 vs fp32 "
              f"{d['fp32_flash', 'fp32', lv]:.3e} (limits: bf16+B1 vs fp32 "
              f"{FEATURE_TOL['flash_spread']} x bf16 vs fp32 = "
              f"{FEATURE_TOL['flash_spread'] * d['bf16', 'fp32', lv]:.3e}; fp32+B1 "
              f"vs fp32 {FEATURE_TOL['fp32_flash']}; UTT, both bf16 routes vs "
              f"fp32 {FEATURE_TOL['bf16']}) [{card}]", flush=True)
    feature_gates(d, label)
    return exs, outs, secs, launches


def b1_at(torch, fa, shape, lens, label: str, card: str, timed: bool = True):
    """B1 (bf16) against its plain version at an encoder's shape and key
    lengths; with ``timed``, its device time beside the plain version's,
    SDPA with the key mask and the bound. Returns the row."""
    q, k, v, kv_len, _ = b1_inputs(torch, torch.bfloat16, shape, list(lens))
    _, err, rel = b1_check(torch, fa, q, k, v, kv_len, "bf16")
    row = dict(max_abs_err=err, rel_err=rel)
    line = (f"[{label}] B1 bf16 B,T,nh,hd={shape} kv_len {min(lens)}-{max(lens)}: "
            f"max_abs_err={err:.3e} rel={rel:.3e} (limit {KERNEL_TOL['bf16']})")
    if timed:
        med = b1_times(torch, fa, q, k, v, kv_len, plain=True)
        b_ms, b_by, flops = b1_bound(lens, "bf16", shape)
        row.update(ms=med["kernel"], plain_ms=med["plain"], library_ms=med["library"],
                   inline_ms=med["inline"], bound_ms=b_ms, bound_by=b_by)
        line += (f"; kernel {med['kernel']:.4f} ms, plain {med['plain']:.4f} ms, "
                 f"encoder inline attention {med['inline']:.4f} ms, SDPA with "
                 f"the key mask {med['library']:.4f} ms (median of 20); bound "
                 f"{b_ms:.4f} ms by {b_by} ({flops / 1e9:.2f} GFLOP)")
    print(f"{line} [{card}]", flush=True)
    return row


def profile_batch(torch, fn, label: str, what: str, card: str) -> None:
    wall, *prof = device_profile(torch, fn)
    print(f"[{label}] profile of one bf16+B1 batch ({what}): wall {wall:.1f} ms, "
          f"{profile_line(*prof, wall)} [{card}]", flush=True)


def phase_text(torch, fa, cfg, card, dev: str = "cuda"):
    """13: MacBERT-large text features (a) through ``TextExtractor.extract``
    in three modes, and (b) through the text CLI's ``_run_extraction``."""
    from mertools_tpu_torch.cli import extract_text
    from mertools_tpu_torch.encoders import bert as tb
    from mertools_tpu_torch.features import text as tt

    t0 = time.perf_counter()
    params = tb.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    print(f"[13 text] MacBERT-large geometry (vocab {cfg.vocab_size}, hidden "
          f"{cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}, "
          f"{cfg.max_position_embeddings} positions), random init "
          f"({sum(p.numel() for p in params.values()) / 1e6:.1f} M params) "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    corpus = text_corpus(np.random.default_rng(13))

    def make(**kw):
        return tt.TextExtractor(cfg, params, batch_size=64, device=dev, **kw)

    batches = text_batches(corpus, tt.DEFAULT_TOKEN_BUCKETS)
    buckets = [b for b, _ in batches]
    check(set(buckets) == set(tt.DEFAULT_TOKEN_BUCKETS),
          f"13 batches hit buckets {buckets}")
    by_len = sorted(corpus, key=lambda n: len(corpus[n]))
    exs, outs, secs, launches = run_modes(
        torch, fa, make, corpus, corpus, len(buckets), cfg.num_hidden_layers,
        "13 text", card, dev)
    n_tok = sum(len(t) for t in corpus.values())
    for mode in MODES:
        print(f"[13 text] {mode}: UTT {len(corpus) / secs[mode, 'UTT']:.1f} "
              f"sentences/s, FRA {len(corpus) / secs[mode, 'FRA']:.1f} "
              f"sentences/s ({len(corpus)} sentences, {n_tok} tokens, batches "
              f"of 64 in buckets {buckets}); B1 launches {launches[mode]} "
              f"[{card}]", flush=True)
    for name, f in outs["bf16_flash", "UTT"].items():
        check(f.shape == (cfg.hidden_size,) and bool(np.isfinite(f).all()),
              f"13 UTT {name}: shape {f.shape} or non-finite")
    for name, f in outs["bf16_flash", "FRA"].items():
        check(f.shape == (min(len(corpus[name]), 512) - 2, cfg.hidden_size)
              and bool(np.isfinite(f).all()), f"13 FRA {name}: shape {f.shape}")

    # fp32 on the card vs the CPU, 3 layers of the same weights (the last-4
    # sum needs 4 hidden states)
    cfg3 = dataclasses.replace(cfg, num_hidden_layers=3)
    sd3 = layer_prefix_sd(params, "encoder.layer.", 3)
    few = {n: corpus[n] for n in by_len[:: len(by_len) // 4]}
    got = tt.TextExtractor(cfg3, sd3, device=dev).extract(few, level="FRA")
    want = tt.TextExtractor(cfg3, sd3, device="cpu").extract(few, level="FRA")
    d_cpu = rel_diff(got, want)
    print(f"[13 text] card vs CPU fp32 (3 layers, {len(few)} sentences of "
          f"{sorted(len(t) for t in few.values())} tokens, FRA): {d_cpu:.3e} "
          f"(limit {FEATURE_TOL['cpu']}) [{card}]", flush=True)
    check(d_cpu <= FEATURE_TOL["cpu"], f"13 card vs CPU {d_cpu}")

    b1 = {}
    if dev == "cuda":
        one = {n: corpus[n] for n in by_len if 64 < len(corpus[n]) <= 128}
        one = dict(list(one.items())[:64])
        profile_batch(torch, lambda: exs["bf16_flash"].extract(one, level="UTT"),
                      "13 text", f"{len(one)} sentences, bucket 128", card)
        # B1 against its plain version at every batch's rows, bucket and key
        # lengths; timed at the first batch of each bucket
        heads = (cfg.num_attention_heads, cfg.hidden_size // cfg.num_attention_heads)
        for bucket, lens in batches:
            row = b1_at(torch, fa, (len(lens), bucket, *heads), lens, "13 text",
                        card, timed=bucket not in b1)
            b1.setdefault(bucket, row)

    # b: the CLI's extraction loop on a transcription CSV with an empty row,
    # and the CLI's main on a checkpoint directory, both through the
    # character tokenizer
    rng = np.random.default_rng(131)
    rows = {f"clip{i:02d}": CharTokenizer.sentence(rng, int(n))
            for i, n in enumerate(rng.integers(8, 97, 11))}
    rows["clip_empty"] = ""
    ex = exs["bf16_flash"]
    with tempfile.TemporaryDirectory() as d:
        trans = os.path.join(d, "transcription.csv")
        with open(trans, "w", newline="", encoding="utf-8") as f:
            f.write("name,chinese\n" + "".join(f"{n},{s}\n" for n, s in rows.items()))
        args = argparse.Namespace(
            trans_path=trans, language="chinese", save_dir=d,
            model_name="chinese-macbert-large", feature_level="UTTERANCE",
            profile=None)
        t0 = time.perf_counter()
        extract_text._run_extraction(args, CharTokenizer(), ex, cfg)
        dt = time.perf_counter() - t0
        out_dir = os.path.join(d, "chinese-macbert-large-UTT")
        feats = {n[:-4]: np.load(os.path.join(out_dir, n))
                 for n in sorted(os.listdir(out_dir))}
    check(sorted(feats) == sorted(rows), f"13b wrote {sorted(feats)}")
    check(not feats.pop("clip_empty").any(), "13b: the empty row is not zeros")
    tok = CharTokenizer()
    lib = ex.extract({n: tok(s)["input_ids"] for n, s in rows.items() if s},
                     level="UTT")
    d_cli = rel_diff(feats, lib)
    print(f"[13 text] b: extract_text._run_extraction (character tokenizer) "
          f"wrote {len(rows)} UTT features ({cfg.hidden_size},) in {dt:.2f} s, "
          f"the empty row zeros; vs TextExtractor.extract bf16+B1: {d_cli:.3e} "
          f"(limit 1e-5) [{card}]", flush=True)
    check(d_cli <= 1e-5, f"13b CLI vs library {d_cli}")

    t0, d_main = time.perf_counter(), cli_text_main(torch, cfg3, sd3, rows, dev)
    print(f"[13 text] b: extract_text.main on config.json + pytorch_model.bin "
          f"(MacBERT-large width, 3 layers, keys under bert.) wrote "
          f"{len(rows)} UTT features in {time.perf_counter() - t0:.2f} s incl. "
          f"loading, the empty row zeros; vs TextExtractor.extract fp32 on the "
          f"same weights: {d_main:.3e} (limit 1e-5) [{card}]", flush=True)
    check(d_main <= 1e-5, f"13b extract_text.main vs library {d_main}")
    return exs["bf16_flash"], sum(launches.values()), b1


def cli_text_main(torch, cfg, sd: dict, rows: dict, dev: str) -> float:
    """``extract_text.main`` on a checkpoint directory written here (a
    ``BertForMaskedLM``-style ``config.json`` + ``pytorch_model.bin``, the
    body's keys under ``bert.``) and a transcription CSV of ``rows``, with
    ``CharTokenizer`` in place of the checkpoint's tokenizer (the card's
    machine has no ``transformers``). Returns its UTT features' distance
    from ``TextExtractor.extract`` on the same weights; fails if the empty
    row is not zeros."""
    from mertools_tpu_torch.cli import extract_text
    from mertools_tpu_torch.core import checkpoint
    from mertools_tpu_torch.features import text as tt

    name = "chinese-macbert-large"
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "ckpt", name)
        os.makedirs(ckpt)
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump({"model_type": "bert", **{k: getattr(cfg, k) for k in (
                "vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
                "intermediate_size", "max_position_embeddings", "type_vocab_size",
                "layer_norm_eps")}}, f)
        torch.save({f"bert.{k}": v for k, v in sd.items()},
                   os.path.join(ckpt, "pytorch_model.bin"))
        trans = os.path.join(d, "transcription.csv")
        with open(trans, "w", newline="", encoding="utf-8") as f:
            f.write("name,chinese\n" + "".join(f"{n},{s}\n" for n, s in rows.items()))
        load_tokenizer = checkpoint.load_tokenizer
        checkpoint.load_tokenizer = lambda path: CharTokenizer()
        try:
            extract_text.main(["--model_name", name, "--pretrain_dir",
                               os.path.join(d, "ckpt"), "--trans_path", trans,
                               "--save_dir", d, "--feature_level", "UTTERANCE",
                               "--device", dev])
        finally:
            checkpoint.load_tokenizer = load_tokenizer
        out_dir = os.path.join(d, f"{name}-UTT")
        feats = {n[:-4]: np.load(os.path.join(out_dir, n))
                 for n in sorted(os.listdir(out_dir))}
    check(sorted(feats) == sorted(rows), f"13b main wrote {sorted(feats)}")
    empty = [n for n, s in rows.items() if not s]
    check(not any(feats.pop(n).any() for n in empty), "13b main: an empty row is not zeros")
    tok = CharTokenizer()
    lib = tt.TextExtractor(cfg, sd, device=dev).extract(
        {n: tok(s)["input_ids"] for n, s in rows.items() if s}, level="UTT")
    return rel_diff(feats, lib)


def face_clips(rng, n: int) -> dict:
    """Random stand-ins for OpenFace's face crops, the synthetic source of
    phases 14 and 15: ``n`` clips of 50-250 frames (2-10 s at 25 fps) of
    112 x 112 x 3 BGR uint8. Phase 16 makes real crops, with the face
    frontend from drawn frames."""
    return {f"clip{i:02d}": rng.integers(0, 256, (int(t), 112, 112, 3), np.uint8)
            for i, t in enumerate(rng.integers(50, 251, n))}


def phase_vision(torch, fa, cfg, card, dev: str = "cuda"):
    """14: CLIP-ViT-L/14 vision features (a) through
    ``VisionExtractor.extract`` in three modes, (b) with ToMe, and (c)
    through ``extract_vision.main`` on a checkpoint directory."""
    from mertools_tpu_torch.cli import extract_vision
    from mertools_tpu_torch.encoders import vit_clip as tc
    from mertools_tpu_torch.features import vision as tvis

    t0 = time.perf_counter()
    params = tc.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    print(f"[14 vision] CLIP-ViT-L/14 geometry (image {cfg.image_size}, patch "
          f"{cfg.patch_size}, {cfg.num_positions} tokens, hidden "
          f"{cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}, "
          f"projection {cfg.projection_dim}), random init "
          f"({sum(p.numel() for p in params.values()) / 1e6:.1f} M params) "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    clips = face_clips(np.random.default_rng(14), 32)
    n_frames = sum(min(len(c), 64) for c in clips.values())
    n_batches = math.ceil(n_frames / 64)

    def make(**kw):
        return tvis.VisionExtractor(cfg, params, batch_size=64, max_frames=64,
                                    device=dev, **kw)

    warm = dict(list(clips.items())[:1])
    exs, outs, secs, launches = run_modes(
        torch, fa, make, clips, warm, n_batches, cfg.num_hidden_layers,
        "14 vision", card, dev)
    for mode in MODES:
        print(f"[14 vision] {mode}: UTT {n_frames / secs[mode, 'UTT']:.1f} "
              f"frames/s = {len(clips) / secs[mode, 'UTT']:.2f} clips/s, FRA "
              f"{n_frames / secs[mode, 'FRA']:.1f} frames/s ({len(clips)} clips "
              f"of {min(len(c) for c in clips.values())}-"
              f"{max(len(c) for c in clips.values())} frames resampled to at "
              f"most 64, {n_frames} frames, {n_batches} batches of 64); B1 "
              f"launches {launches[mode]} [{card}]", flush=True)
    P = cfg.projection_dim
    for name, f in outs["bf16_flash", "UTT"].items():
        check(f.shape == (P,) and bool(np.isfinite(f).all()),
              f"14 UTT {name}: shape {f.shape} or non-finite")
    for name, f in outs["bf16_flash", "FRA"].items():
        check(f.shape == (min(len(clips[name]), 64), P)
              and bool(np.isfinite(f).all()), f"14 FRA {name}: shape {f.shape}")

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    sd2 = layer_prefix_sd(params, "encoder.layers.", 2)
    few = {"clip00": clips["clip00"][:4]}
    got = tvis.VisionExtractor(cfg2, sd2, device=dev).extract(few, level="FRA")
    want = tvis.VisionExtractor(cfg2, sd2, device="cpu").extract(few, level="FRA")
    d_cpu = rel_diff(got, want)
    print(f"[14 vision] card vs CPU fp32 (2 layers, 4 frames, FRA): "
          f"{d_cpu:.3e} (limit {FEATURE_TOL['cpu']}) [{card}]", flush=True)
    check(d_cpu <= FEATURE_TOL["cpu"], f"14 card vs CPU {d_cpu}")

    b1 = {}
    if dev == "cuda":
        profile_batch(torch, lambda: exs["bf16_flash"].extract(warm, level="UTT"),
                      "14 vision", f"{min(len(warm['clip00']), 64)} frames", card)
        hd = cfg.hidden_size // cfg.num_attention_heads
        b1 = b1_at(torch, fa, (64, cfg.num_positions, cfg.num_attention_heads, hd),
                   [cfg.num_positions] * 64, "14 vision", card)

    # b: ToMe r 8 in bf16 on the plain route, beside the full tower
    sub = dict(list(clips.items())[:4])
    t0 = time.perf_counter()
    tome = tvis.VisionExtractor(dataclasses.replace(cfg, tome_r=8), params,
                                compute_dtype="bf16", device=dev).extract(sub, level="UTT")
    dt = time.perf_counter() - t0
    for name, f in tome.items():
        check(f.shape == (P,) and bool(np.isfinite(f).all()),
              f"14b ToMe {name}: shape {f.shape} or non-finite")
    d_tome = rel_diff(tome, {n: outs["bf16", "UTT"][n] for n in sub})
    print(f"[14 vision] b: ToMe r 8 (bf16, plain attention; 257 tokens merged "
          f"8 a layer while (N - 1) // 2 allows): {len(sub)} clips in {dt:.2f} s "
          f"incl. set-up, UTT ({P},) finite; vs the full tower in bf16: "
          f"{d_tome:.3e} of max (an approximation, no limit) [{card}]", flush=True)

    # c: the CLI on a checkpoint directory (config.json + pytorch_model.bin)
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "ckpt", "clip-vit-large-patch14")
        os.makedirs(ckpt)
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump({"model_type": "clip_vision_model", "hidden_size": cfg.hidden_size,
                       "num_hidden_layers": 2, "num_attention_heads": cfg.num_attention_heads,
                       "intermediate_size": cfg.intermediate_size,
                       "image_size": cfg.image_size, "patch_size": cfg.patch_size,
                       "projection_dim": P, "layer_norm_eps": cfg.layer_norm_eps}, f)
        torch.save(sd2, os.path.join(ckpt, "pytorch_model.bin"))
        faces = os.path.join(d, "faces")
        os.makedirs(faces)
        for n, c in sub.items():
            np.save(os.path.join(faces, f"{n}.npy"), c)
        t0 = time.perf_counter()
        extract_vision.main(["--model_name", "clip-vit-large-patch14",
                             "--pretrain_dir", os.path.join(d, "ckpt"),
                             "--face_dir", faces, "--save_dir", d,
                             "--feature_level", "UTTERANCE", "--device", dev])
        dt = time.perf_counter() - t0
        out_dir = os.path.join(d, "clip-vit-large-patch14-UTT")
        feats = {n[:-4]: np.load(os.path.join(out_dir, n))
                 for n in sorted(os.listdir(out_dir))}
    lib = tvis.VisionExtractor(cfg2, sd2, device=dev).extract(sub, level="UTT")
    d_cli = rel_diff(feats, lib)
    print(f"[14 vision] c: extract_vision.main on config.json + "
          f"pytorch_model.bin (CLIP-L width, 2 layers) wrote {len(feats)} UTT "
          f"features in {dt:.2f} s incl. loading; vs VisionExtractor.extract "
          f"fp32 on the same weights: {d_cli:.3e} (limit 1e-5) [{card}]", flush=True)
    check(sorted(feats) == sorted(sub), f"14c wrote {sorted(feats)}")
    check(d_cli <= 1e-5, f"14c CLI vs library {d_cli}")
    return exs["bf16_flash"], sum(launches.values()), b1


def release_card_vs_cpu(torch, d: str, fdir: str, corpora: dict, feats,
                        dev: str, label: str) -> dict:
    """``main_release`` MER2023 attention fusion (trimodal, hidden 256,
    dropout 0, 3 epochs, 5 folds) on the UTT features ``feats`` (audio,
    text, video) under ``fdir``, on the card and on the CPU. As in 12c, the
    card is held to the CPU from the same weights: two whole runs drift
    apart as far as Adam lets rounding grow, which on these features can
    pass 1e-4, so their distance is only returned. Returns the runs, their
    seconds and the three distances."""
    from mertools_tpu_torch.cli import main_release
    from mertools_tpu_torch.core.config import Args
    from mertools_tpu_torch.core.globals_mer import EMO2IDX_MER
    from mertools_tpu_torch.data import labels
    from mertools_tpu_torch.data.dataset import FeatureDataset

    labels.write_label_archive(os.path.join(d, "label.npz"), corpora)
    sets = {split: FeatureDataset.build(
        list(c), np.array([EMO2IDX_MER[v["emo"]] for v in c.values()]),
        np.array([v["val"] for v in c.values()], np.float32),
        *(os.path.join(fdir, f) for f in feats))
        for split, c in corpora.items()}
    runs, secs, files = {}, {}, {}
    for leg, where in (("card", dev), ("cpu", "cpu")):
        save = os.path.join(d, f"saved_{leg}")
        t0 = time.perf_counter()
        runs[leg] = main_release.main(fusion_flags(
            fdir, os.path.join(d, "label.npz"), save, feats,
            "--hidden_dim=256", "--dropout=0", "--lr=1e-3", "--epochs=3",
            "--device", where))
        secs[leg] = time.perf_counter() - t0
        files[leg] = sorted(re.sub(r"_[0-9.]+\.npz$", "", f) for f in
                            os.listdir(os.path.join(f"{save}-trimodal", "result")))
    for leg, fs in files.items():
        check([f.split("_")[0] for f in fs] == ["cv", "test1"], f"{label} {leg} wrote {fs}")
    got = runs["card"].test_results["test1"]["emoprobs"]
    check(got.shape == (len(corpora["test1"]), 6) and bool(np.isfinite(got).all()),
          f"{label} test1 logits {got.shape} or non-finite")
    args = Args(model="attention", feat_type="utt", hidden_dim=256, dropout=0.0,
                lr=1e-3, l2=1e-5, grad_clip=-1.0, batch_size=32, epochs=3,
                num_folder=5, output_dim1=6, output_dim2=1, metric_name="emoval")
    d_grad, d_eval = same_weights_check(torch, args, sets, dev,
                                        np.random.default_rng(0), epochs=3)
    check(d_grad <= FUSION_TOL, f"{label} card vs CPU gradients {d_grad}")
    check(d_eval <= FUSION_TOL, f"{label} card vs CPU test logits {d_eval}")
    return dict(runs=runs, secs=secs, d_grad=d_grad, d_eval=d_eval,
                d_runs=fusion_card_vs_cpu(runs["card"], runs["cpu"], "test1"))


def release_line(r: dict) -> str:
    """How :func:`release_card_vs_cpu` went, as phases 15 and 16 print it."""
    return (f"main_release MER2023 attention (trimodal, hidden 256, dropout 0, 3 "
            f"epochs, 5 folds of 30 train clips, test1 10 clips) "
            f"{r['secs']['card']:.1f} s on the card, {r['secs']['cpu']:.1f} s on "
            f"the CPU; cv {r['runs']['card'].cv_str} (CPU {r['runs']['cpu'].cv_str}); "
            f"card vs CPU from the same weights (as 12c): a step's gradients "
            f"{r['d_grad']:.3e}, test1 logits and valence of the card's model "
            f"after 3 epochs {r['d_eval']:.3e} of max|cpu| (limit {FUSION_TOL}); "
            f"the two main_release runs' test1 outputs {r['d_runs']:.3e} apart")


def phase_trimodal(torch, fa, ex_text, ex_vis, card, dev: str = "cuda"):
    """15: MER2023's trimodal pipeline on 12a's 40 clips, each with a seeded
    transcript and face crops: HuBERT-large UTT (``extract_audio``),
    MacBERT-large UTT (phase 13's extractor through the text CLI's loop) and
    CLIP-L UTT (phase 14's through the vision CLI's loop), then
    :func:`release_card_vs_cpu`. Returns B1's launches and what phase 16
    takes across: the label corpora and the audio and text features."""
    from mertools_tpu_torch.cli import extract_audio, extract_text, extract_vision
    from mertools_tpu_torch.core.globals_mer import feature_dir_name

    rng = np.random.default_rng(12)   # 12a's wavs and labels
    pcm = {f"clip{i:02d}": (rng.normal(size=int(s * SR)) * 3000).astype(np.int16)
           for i, s in enumerate(rng.uniform(2, 10, 40))}
    names = sorted(pcm)
    corpora, _ = fusion_labels(rng, {"train": names[:30], "test1": names[30:]})
    rng = np.random.default_rng(15)
    trans = {n: CharTokenizer.sentence(rng, int(k))
             for n, k in zip(names, rng.integers(8, 97, 40))}
    feats = [feature_dir_name(m, "UTT") for m in
             ("chinese-hubert-large", "chinese-macbert-large", "clip-vit-large-patch14")]
    secs = {}
    with tempfile.TemporaryDirectory() as d:
        fdir = os.path.join(d, "features")
        write_wavs(os.path.join(d, "audio"), pcm)
        os.makedirs(os.path.join(d, "faces"))
        n_frames = 0
        for n, c in face_clips(rng, 40).items():
            np.save(os.path.join(d, "faces", f"{n}.npy"), c)
            n_frames += min(len(c), 64)
        with open(os.path.join(d, "transcription.csv"), "w", newline="",
                  encoding="utf-8") as f:
            f.write("name,chinese\n" + "".join(f"{n},{s}\n" for n, s in trans.items()))
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        extract_audio.main([
            "--model_name", "chinese-hubert-large", "--audio_dir",
            os.path.join(d, "audio"), "--save_dir", fdir, "--random_init",
            "--encoder_size", "large", "--compute_dtype", "bf16",
            "--transfer_dtype", "int16", "--feature_level", "UTTERANCE",
            "--device", dev])
        secs["audio"] = time.perf_counter() - t0
        common = dict(save_dir=fdir, feature_level="UTTERANCE", profile=None)
        t0 = time.perf_counter()
        extract_text._run_extraction(argparse.Namespace(
            trans_path=os.path.join(d, "transcription.csv"), language="chinese",
            model_name="chinese-macbert-large", **common),
            CharTokenizer(), ex_text, ex_text.cfg)
        secs["text"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        extract_vision._run_extraction(argparse.Namespace(
            face_dir=os.path.join(d, "faces"), model_name="clip-vit-large-patch14",
            **common), ex_vis)
        secs["vision"] = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        dims = {f: np.load(os.path.join(fdir, f, "clip00.npy")).shape for f in feats}
        handoff = {"corpora": corpora, "features": {
            f: {n: np.load(os.path.join(fdir, f, f"{n}.npy")) for n in names}
            for f in feats[:2]}}
        r = release_card_vs_cpu(torch, d, fdir, corpora, feats, dev, "15")
    print(f"[15 trimodal] 40 clips: extract_audio HuBERT-large (bf16, int16 "
          f"wire) {secs['audio']:.1f} s incl. init, MacBERT-large (bf16+B1, "
          f"transcripts of 8-96 tokens) {secs['text']:.2f} s, CLIP-L (bf16+B1, "
          f"50-250 face frames a clip) {secs['vision']:.2f} s; UTT widths "
          f"{ {f: s for f, s in dims.items()} }; B1 launches {launches}; "
          f"{release_line(r)} [{card}]", flush=True)
    # one text batch of 40 sentences and the face frames in batches of 64,
    # one launch a layer
    want = (ex_text.cfg.num_hidden_layers
            + ex_vis.cfg.num_hidden_layers * math.ceil(n_frames / 64))
    check(launches == want, f"15: {launches} B1 launches, want {want}")
    return launches, handoff


# ------------------------------------------------------------ faces (16)
FACE_FRAME = (360, 640)            # H, W of phase 16's RGB frames
FACE_GATES = {"usable": 0.95, "iou": 0.75}   # PARITY.md: 1.00 and 0.85-0.86
# card vs CPU on BlazeFace's scores and raw boxes, max |card - cpu| /
# max |cpu| (fp32, TF32 off)
BLAZE_TOL = 1e-4


def draw_faces(torch, H: int, W: int, cx, cy, s: float, gen, noise: float = 3.0,
               contrast: float = 1.0, device="cuda"):
    """The port-side copy of ``draw_face`` in
    ``tests/test_face_frontend_fidelity.py``, batched over frames on
    ``device`` in float64: a synthetic Haar-detectable face of size ``s``
    centred at (cx[t], cy[t]) on frame t, noise from ``gen``, then scipy's
    ``gaussian_filter`` (sigma 3 s / 100, radius 4 sigma, mirrored edges).
    Returns (the (T, H, W) gray frames, not clipped, and the ground-truth
    core-face boxes (T, 4) [x, y, w, h] as numpy)."""
    f64 = torch.float64
    cxt = torch.as_tensor(np.asarray(cx, np.float64), device=device)[:, None, None]
    cyt = torch.as_tensor(np.asarray(cy, np.float64), device=device)[:, None, None]
    yy = torch.arange(H, dtype=f64, device=device)[None, :, None]
    xx = torch.arange(W, dtype=f64, device=device)[None, None, :]
    img = torch.full((len(cx), H, W), 200.0, dtype=f64, device=device)

    def ellipse(x0, y0, rx, ry, val):
        img[((xx - x0) / rx) ** 2 + ((yy - y0) / ry) ** 2 <= 1] = 200.0 + (val - 200.0) * contrast

    ellipse(cxt, cyt, 0.55 * s, 0.75 * s, 195)
    for ex in (cxt - 0.25 * s, cxt + 0.25 * s):
        ellipse(ex, cyt - 0.20 * s, 0.14 * s, 0.06 * s, 90)
        ellipse(ex, cyt - 0.03 * s, 0.08 * s, 0.08 * s, 40)
    ellipse(cxt, cyt + 0.35 * s, 0.08 * s, 0.12 * s, 160)
    ellipse(cxt, cyt + 0.55 * s, 0.22 * s, 0.08 * s, 95)
    if noise:
        img = img + torch.randn(img.shape, generator=gen, dtype=f64, device=device) * noise
    sigma = 3.0 * s / 100
    r = int(4.0 * sigma + 0.5)
    k = np.exp(-0.5 / sigma ** 2 * np.arange(-r, r + 1) ** 2)
    k = (k / k.sum()).tolist()
    for dim in (1, 2):            # scipy filters axis 0, then axis 1
        n = img.shape[dim]
        pad = torch.cat([img.narrow(dim, 0, r).flip(dim), img,
                         img.narrow(dim, n - r, r).flip(dim)], dim)
        img = sum(w * pad.narrow(dim, j, n) for j, w in enumerate(k))
    cxn, cyn = np.asarray(cx, np.float64), np.asarray(cy, np.float64)
    gt = np.stack([cxn - 0.45 * s, cyn - 0.35 * s, np.full_like(cxn, 0.9 * s),
                   np.full_like(cxn, 1.1 * s)], 1)
    return img, gt


def face_iou(a, b) -> float:
    """IoU of two [x, y, w, h] boxes."""
    iw = max(0.0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    ih = max(0.0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = iw * ih
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def face_video_clips(torch, names, frames_range=(12, 37), seed: int = 16,
                     device="cuda") -> dict:
    """Phase 16's clips: for each name, 12-36 RGB uint8 frames of
    ``FACE_FRAME`` with a drawn face (size 90-150 px, noise 3) drifting 4 px
    a frame with +-3 px jitter, the protocol of
    ``test_video_track_through_occlusion``; every fourth clip carries the
    severe mouth occluder on its middle third. Returns {name: (frames,
    ground-truth core-face boxes)}."""
    H, W = FACE_FRAME
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for i, name in enumerate(names):
        T = int(rng.integers(*frames_range))
        s = float(rng.uniform(90, 150))
        cx0 = rng.uniform(0.55 * s + 8, W - 0.55 * s - 8 - 4.0 * T)
        cy0 = rng.uniform(0.75 * s + 8, H - 0.75 * s - 8)
        cx = cx0 + 4.0 * np.arange(T) + rng.integers(-3, 4, T)
        cy = cy0 + rng.integers(-3, 4, T)
        img, gt = draw_faces(torch, H, W, cx, cy, s, gen, device=device)
        if i % 4 == 3:
            for t in range(T // 3, 2 * T // 3):
                y0, x0 = int(cy[t] + 0.35 * s), int(cx[t] - 0.3 * s)
                img[t, y0: y0 + int(0.25 * s), x0: x0 + int(0.6 * s)] = 30
        frames = img.clamp(0, 255).to(torch.uint8)[..., None].expand(-1, -1, -1, 3)
        out[name] = (frames.cpu().numpy(), gt)
    return out


def haar_gates(tracks: list, truths: list) -> tuple[float, float, int]:
    """Phase 16a's gates on the Haar route's tracks against the drawn
    truth: the share of frames with usable geometry (a finite box) and the
    median IoU of their calibrated core-face boxes. Returns (usable share,
    median IoU, frames re-measured from the eyes)."""
    from mertools_tpu_torch.ops.face_haar import core_face_box

    usable, ious, eyes = [], [], 0
    for tr, gt in zip(tracks, truths):
        eyes += int((tr["source"] == 2).sum())
        for box, g in zip(tr["boxes"], gt):
            ok = bool(np.isfinite(box).all())
            usable.append(ok)
            if ok:
                ious.append(face_iou(core_face_box(box), g))
    rate = float(np.mean(usable))
    med = float(np.median(ious)) if ious else 0.0
    check(rate >= FACE_GATES["usable"], f"16a usable-geometry rate {rate}")
    check(med >= FACE_GATES["iou"], f"16a median core-face IoU {med}")
    return rate, med, eyes


def evaluator_gate(calls: dict) -> None:
    """Phase 16a: the native Haar evaluator ran and the numpy one did not."""
    check(calls["native"] > 0 and calls["numpy"] == 0,
          f"16a Haar evaluator calls {calls}: want native only")


def warp_gate(dev_crops: dict, host_crops: dict) -> float:
    """Phase 16b: the device warp within one level of the host warp on
    every clip. Returns the share of pixels that differ."""
    n_diff = n_all = 0
    for name, ref in host_crops.items():
        got = dev_crops[name]
        check(got.shape == ref.shape, f"16b {name}: {got.shape} vs {ref.shape}")
        diff = np.abs(got.astype(int) - ref)
        check(int(diff.max()) <= 1, f"16b {name}: device vs host warp {diff.max()} levels")
        n_diff += int((diff > 0).sum())
        n_all += diff.size
    return n_diff / n_all


# BlazeFace's blocks as the JAX package's Flax module lists them: (name,
# stride); widths come from the weights
BLAZE_BLOCKS = (("b0_0", 1), ("b0_1", 1), ("d1", 2), ("b1_0", 1), ("b1_1", 1),
                ("d2", 2), ("b2_0", 1), ("b2_1", 1), ("d3", 2), ("b3_0", 1),
                ("b3_1", 1))


def blaze_plain(torch, sd: dict, x):
    """BlazeFace's forward written out with functional ops, each
    convolution padded by Flax's "SAME" rule (total max((out - 1) * stride
    + k - in, 0), the smaller half first): the plain version phase 16c holds
    ``face_detect.BlazeFace`` to. x: (B, 128, 128, 3) [0,1]."""
    F = torch.nn.functional

    def conv(x, pre, stride=1, groups=1):
        w = sd[f"{pre}.weight"]
        pads = []
        for n in (x.shape[3], x.shape[2]):            # W, then H, as F.pad
            total = max((-(-n // stride) - 1) * stride + w.shape[-1] - n, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(x, pads), w, sd[f"{pre}.bias"], stride=stride,
                        groups=groups)

    x = F.relu(conv(x.permute(0, 3, 1, 2), "stem", 2))
    feats = []
    for name, stride in BLAZE_BLOCKS:
        y = conv(conv(x, f"{name}.dw", stride, x.shape[1]), f"{name}.pw")
        if stride == 2:
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(y + F.pad(x, (0, 0, 0, 0, 0, y.shape[1] - x.shape[1])))
        if name in ("b2_1", "b3_1"):
            feats.append(x)
    scores, boxes = [], []
    for feat, tag in zip(feats, ("s16", "s8")):
        scores.append(conv(feat, f"score_{tag}").permute(0, 2, 3, 1).reshape(len(feat), -1))
        boxes.append(conv(feat, f"box_{tag}").permute(0, 2, 3, 1).reshape(len(feat), -1, 14))
    return torch.cat(scores, 1), torch.cat(boxes, 1)


def blaze_gate(card: tuple, plain: tuple, cpu: tuple) -> tuple[float, float]:
    """Phase 16c: ``BlazeFace``'s scores and raw boxes on the card within
    ``BLAZE_TOL`` of max|plain| of :func:`blaze_plain`'s on the card, and of
    max|cpu| of its own on the CPU, with the same best anchor a frame.
    Returns the two distances."""
    out = []
    for ref, what in ((plain, "the plain forward"), (cpu, "the CPU")):
        d = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(card, ref))
        check(d <= BLAZE_TOL, f"16c BlazeFace vs {what}: {d}")
        check(bool((card[0].argmax(1) == ref[0].argmax(1)).all()),
              f"16c BlazeFace best anchors differ from {what}'s")
        out.append(d)
    return tuple(out)


def blur_plain(torch, frames, rate: int):
    """The pyramid blur by ``F.interpolate`` (bilinear, antialiased, half
    pixel centres), which equals ``jax.image.resize``'s linear resize up to
    float32 rounding: the plain version phase 16d holds ``blur_frames`` to.
    frames: (T, H, W, C) uint8 tensor."""
    F = torch.nn.functional
    x = frames.float().permute(0, 3, 1, 2)
    steps = int(math.log2(rate))
    for _ in range(steps):
        x = F.interpolate(x, size=(x.shape[2] // 2, x.shape[3] // 2),
                          mode="bilinear", antialias=True, align_corners=False)
    for _ in range(steps):
        x = F.interpolate(x, size=(x.shape[2] * 2, x.shape[3] * 2),
                          mode="bilinear", antialias=True, align_corners=False)
    return torch.round(x).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


def blur_gate(got: np.ndarray, plain: np.ndarray, cpu: np.ndarray, rate: int) -> None:
    """Phase 16d: the card's blur within one level of the plain version's
    at the same rate (a blur at another rate lies tens of levels away), and
    of the CPU's on the frames both ran."""
    for ref, what in ((plain, "the plain version"), (cpu, "the CPU")):
        check(got[: len(ref)].shape == ref.shape,
              f"16d rate {rate}: {got.shape} vs {what}'s {ref.shape}")
        d = int(np.abs(got[: len(ref)].astype(int) - ref).max())
        check(d <= 1, f"16d rate {rate}: blur vs {what} {d} levels")


def to_flax_tree(state_dict: dict) -> dict:
    """``BlazeFace.state_dict()`` -> the Flax parameter tree the JAX
    package saves (the inverse of ``face_detect.from_flax``)."""
    tree = {}
    for key, v in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        a = v.detach().cpu().numpy()
        node["kernel" if leaf == "weight" else "bias"] = (
            a.transpose(2, 3, 1, 0) if leaf == "weight" else a)
    return tree


def phase_faces(torch, fa, ex_vis, handoff: dict, card, dev: str = "cuda",
                frames_range=(12, 37)):
    """16: the face frontend on 40 drawn clips of 640 x 360 (phase 15's
    names) of 12-36 frames, written as frame .npy files (the host Haar
    route's cost set the frame count: PERF.md §4): (a) ``preprocess detect-faces``'s
    Haar route with its defaults (host detection and tracking, the warp on
    the card), gated against the drawn truth; (b) ``crop_video``'s device
    warp against its host warp on the same landmarks; (c) BlazeFace at
    width 32 from a seeded init, card against CPU, its frames/s and idle
    share, and ``detect-faces --detector_params`` on 4 clips; (d)
    ``blur_frames`` at rates 2, 4 and 8, card against CPU; (e) CLIP-L UTT
    features (phase 14's bf16+B1 extractor) of (a)'s stores, and
    ``main_release`` on them with phase 15's HuBERT and MacBERT features.
    Returns B1's launches in (e)."""
    from mertools_tpu_torch.cli import extract_vision, preprocess
    from mertools_tpu_torch.core.device import resolve_device, upload
    from mertools_tpu_torch.data.corruption import blur_frames
    from mertools_tpu_torch.ops import face_detect as fd
    from mertools_tpu_torch.ops import face_haar, viola_jones
    from mertools_tpu_torch.ops.image import resize_separable

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    names = sorted(handoff["features"][next(iter(handoff["features"]))])
    t_phase = t0 = time.perf_counter()
    clips = face_video_clips(torch, names, frames_range, device=dev)
    n_frames = sum(len(f) for f, _ in clips.values())
    secs = {"draw": time.perf_counter() - t0}
    with tempfile.TemporaryDirectory() as d:
        vids, faces = os.path.join(d, "frames"), os.path.join(d, "faces")
        os.makedirs(vids)
        for n, (frames, _) in clips.items():
            np.save(os.path.join(vids, f"{n}.npy"), frames)

        # a: the Haar route, its tracks recorded in the CLI's clip order and
        # the seconds spent in the window evaluator and the grouping summed
        tracks, track_video = [], face_haar.HaarFaceFrontend.track_video
        parts = {"_detect_single_scale_native": 0.0, "group_rectangles": 0.0}
        timed = {n: getattr(viola_jones, n) for n in parts}

        def recording(self, frames):
            tracks.append(track_video(self, frames))
            return tracks[-1]

        def timing(name):
            def run(*args, **kw):
                t = time.perf_counter()
                try:
                    return timed[name](*args, **kw)
                finally:
                    parts[name] += time.perf_counter() - t
            return run

        face_haar.HaarFaceFrontend.track_video = recording
        for n in parts:
            setattr(viola_jones, n, timing(n))
        viola_jones.EVALUATOR_CALLS.update(native=0, numpy=0)
        try:
            t0 = time.perf_counter()
            preprocess.main(["detect-faces", "--video_root", vids,
                             "--save_root", faces, "--device", dev])
            secs["haar"] = time.perf_counter() - t0
        finally:
            face_haar.HaarFaceFrontend.track_video = track_video
            for n, fn in timed.items():
                setattr(viola_jones, n, fn)
        calls = dict(viola_jones.EVALUATOR_CALLS)
        evaluator_gate(calls)
        rate, med, eyes = haar_gates(tracks, [gt for _, gt in clips.values()])
        stores = {n: np.load(os.path.join(faces, f"{n}.npy")) for n in names}
        for n, st in stores.items():
            check(st.dtype == np.uint8 and st.shape == (len(clips[n][0]), 112, 112, 3),
                  f"16a store {n}: {st.dtype} {st.shape}")
        print(f"[16 faces] a: detect-faces Haar route (defaults, warp on "
              f"{dev}) on {len(clips)} clips of {FACE_FRAME[1]} x {FACE_FRAME[0]} "
              f"RGB, {min(len(f) for f, _ in clips.values())}-"
              f"{max(len(f) for f, _ in clips.values())} frames ({n_frames} "
              f"frames; every 4th clip with the severe mouth occluder on its "
              f"middle third; drawn on the card in {secs['draw']:.1f} s): "
              f"{secs['haar']:.1f} s = {n_frames / secs['haar']:.1f} frames/s "
              f"with {os.cpu_count()} CPU cores; usable geometry {rate:.3f} "
              f"(gate {FACE_GATES['usable']}), median core-face IoU {med:.3f} "
              f"(gate {FACE_GATES['iou']}), {eyes} frames re-measured from the "
              f"eye pair; Haar evaluator calls {calls}; of the route's "
              f"seconds, the native window evaluator "
              f"{parts['_detect_single_scale_native']:.1f} s, the rectangle "
              f"grouping (Python) {parts['group_rectangles']:.1f} s, the rest "
              f"(pyramid, integral images, gray, tracking, warp, file IO) "
              f"{secs['haar'] - sum(parts.values()):.1f} s [{card}]", flush=True)

        # b: the device warp against the host warp on the same landmarks
        fe = face_haar.HaarFaceFrontend()
        crops, ms = {"device": {}, "host": {}}, {"device": 0.0, "host": 0.0}
        for backend in ("device", "host"):
            fe.track_video = lambda f: tracks[0]
            fe.crop_video(clips[names[0]][0], warp_backend=backend, device=dev)
            for n, tr in zip(names, tracks):
                fe.track_video = lambda f, tr=tr: tr
                sync()
                t0 = time.perf_counter()
                crops[backend][n], _ = fe.crop_video(clips[n][0], warp_backend=backend,
                                                     device=dev)
                ms[backend] += (time.perf_counter() - t0) * 1e3 / len(names)
        share = warp_gate(crops["device"], crops["host"])
        for n in names:
            check(np.array_equal(crops["device"][n], stores[n]),
                  f"16b {n}: crop_video differs from the CLI's store")
        print(f"[16 faces] b: crop_video on a's landmarks, device warp vs host "
              f"warp: max 1 level, {share:.2e} of the values differ; "
              f"{ms['device']:.2f} ms a clip on the device (uint8 upload, "
              f"Umeyama, warp, download), {ms['host']:.2f} ms on the host "
              f"(numpy twins) [{card}]", flush=True)

        # c: BlazeFace at width 32 from a seeded init, fp32 with TF32 off
        torch.manual_seed(16)
        sd = fd.BlazeFace(32).state_dict()
        dets = {"card": fd.FaceDetector(sd, 32, device=dev),
                "cpu": fd.FaceDetector(sd, 32, device="cpu")}
        stacked = np.concatenate([f for f, _ in clips.values()])
        outs = {}
        for leg, det in dets.items():
            x = upload(stacked[:256], det.device)
            with torch.no_grad():
                small = resize_separable(x.float() / 255.0, fd.INPUT_SIZE,
                                         fd.INPUT_SIZE, "bilinear")
                outs[leg] = tuple(o.cpu() for o in det.model(small))
                if leg == "card":
                    sd_card = {k: v.to(det.device) for k, v in sd.items()}
                    outs["plain"] = tuple(o.cpu() for o in blaze_plain(torch, sd_card, small))
        d_plain, d_blaze = blaze_gate(outs["card"], outs["plain"], outs["cpu"])
        det = dets["card"]
        preprocess.blazeface_align(det, stacked[:256])
        sync()
        t0 = time.perf_counter()
        _, probs = preprocess.blazeface_align(det, stacked)
        sync()
        secs["blaze"] = time.perf_counter() - t0
        check(probs.shape == (n_frames,) and bool(np.isfinite(probs).all()),
              f"16c probabilities {probs.shape} or non-finite")
        prof = ""
        if dev == "cuda":
            wall, *p = device_profile(torch, lambda: preprocess.blazeface_align(
                det, stacked[:256]))
            prof = (f"; profile of one batch of 256: wall {wall:.1f} ms, "
                    f"{profile_line(*p, wall)}")
        pfile = os.path.join(d, "blazeface.npz")
        np.savez(pfile, params=np.array(to_flax_tree(sd), dtype=object))
        four = os.path.join(d, "four")
        os.makedirs(four)
        for n in names[:4]:
            os.symlink(os.path.join(vids, f"{n}.npy"), os.path.join(four, f"{n}.npy"))
        out4 = os.path.join(d, "blaze_faces")
        t0 = time.perf_counter()
        preprocess.main(["detect-faces", "--video_root", four, "--save_root", out4,
                         "--detector_params", pfile, "--device", dev])
        secs["blaze_cli"] = time.perf_counter() - t0
        for n in names[:4]:
            aligned, p = preprocess.blazeface_align(det, clips[n][0])
            keep = p >= 0.5
            want = aligned[keep] if keep.any() else aligned[:1] * 0
            want = np.clip(want[..., ::-1], 0, 255).astype(np.uint8)
            got = np.load(os.path.join(out4, f"{n}.npy"))
            check(got.shape == want.shape and int(np.abs(got.astype(int) - want).max()) <= 1,
                  f"16c detect-faces --detector_params {n}: {got.shape} vs {want.shape}")
        print(f"[16 faces] c: BlazeFace width 32 (seeded init, fp32, TF32 off), "
              f"128 x 128 inputs resized on the card from uint8 uploads: "
              f"on 256 frames, scores and raw boxes vs the plain functional "
              f"forward on the card {d_plain:.3e} of max|plain|, vs the CPU "
              f"{d_blaze:.3e} of max|cpu| (limit {BLAZE_TOL}), best anchors "
              f"equal; detect + align (blazeface_align, batches of 256) "
              f"{n_frames} frames in {secs['blaze']:.2f} s = "
              f"{n_frames / secs['blaze']:.1f} frames/s{prof}; detect-faces "
              f"--detector_params on 4 clips {secs['blaze_cli']:.2f} s incl. "
              f"loading, equal to the library [{card}]", flush=True)

        # d: the pyramid blur against its plain version and the CPU's
        clip = clips[names[0]][0]
        blur_ms = {}
        for rate in (2, 4, 8):
            blur_frames(clip[:4], rate, device=dev)
            sync()
            t0 = time.perf_counter()
            got = blur_frames(clip, rate, device=dev)
            blur_ms[rate] = (time.perf_counter() - t0) * 1e3
            plain = blur_plain(torch, upload(clip, resolve_device(dev, fp32=True)), rate)
            blur_gate(got, plain.cpu().numpy(), blur_frames(clip[:16], rate, device="cpu"),
                      rate)
        print(f"[16 faces] d: blur_frames on a clip of {len(clip)} frames of "
              f"{FACE_FRAME[1]} x {FACE_FRAME[0]}: "
              + ", ".join(f"rate {r} {t:.1f} ms" for r, t in blur_ms.items())
              + f" (uint8 upload, resizes, download); within 1 level of the "
              f"plain version (F.interpolate) on the card and of the CPU's on "
              f"the first 16 frames [{card}]", flush=True)

        # e: CLIP-L on the detected crops, then the trimodal release
        fdir = os.path.join(d, "features")
        for f, feats in handoff["features"].items():
            os.makedirs(os.path.join(fdir, f))
            for n, a in feats.items():
                np.save(os.path.join(fdir, f, f"{n}.npy"), a)
        vision = "clip-vit-large-patch14-UTT"
        fa.flash_attention.launches = 0
        t0 = time.perf_counter()
        extract_vision._run_extraction(argparse.Namespace(
            face_dir=faces, model_name="clip-vit-large-patch14", save_dir=fdir,
            feature_level="UTTERANCE", profile=None), ex_vis)
        secs["vision"] = time.perf_counter() - t0
        launches = fa.flash_attention.launches
        want = ex_vis.cfg.num_hidden_layers * math.ceil(
            sum(min(len(s), 64) for s in stores.values()) / 64)
        check(launches == want, f"16e: {launches} B1 launches, want {want}")
        r = release_card_vs_cpu(torch, d, fdir, handoff["corpora"],
                                [*handoff["features"], vision], dev, "16e")
    print(f"[16 faces] e: CLIP-L UTT (bf16+B1) of a's {len(stores)} stores "
          f"{secs['vision']:.2f} s, B1 launches {launches} (B 64 x 257); "
          f"with phase 15's HuBERT and MacBERT features: {release_line(r)} "
          f"[{card}]", flush=True)
    print(f"[16 faces] phase 16 took {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return launches


def b3_times_of(torch, root: str) -> int:
    """Phase 9's bf16 timing lines (S 512 and S 1024), phase 2's bf16 B1
    line (kernel, SDPA with the key mask, bound) and phase 5's B2 line
    (kernel, plain version, bound) for the port in the checkout at
    ``root``, e.g. an earlier commit unpacked beside this one, so two
    versions of the kernels can be compared within one call."""
    sys.path.insert(0, os.path.abspath(root))
    from mertools_tpu_torch.ops import flash_attention as fa
    from mertools_tpu_torch.ops import flash_attention_causal as fc

    card = card_line()
    print(f"[b3 times] {fc.__file__} [{card}]", flush=True)
    b3_line(b3_times(torch, fc, B3_LENS, 512, plain=False),
            f"B=8 S=512 lens={list(B3_LENS)}", card)
    b3_line(b3_times(torch, fc, (1024,) * 4, 1024, plain=False),
            "B=4 S=1024 full lengths", card)
    q, k, v, kv_len, lens = b1_inputs(torch, torch.bfloat16)
    med = b1_times(torch, fa, q, k, v, kv_len, plain=False)
    b_ms, b_by, _ = b1_bound(lens, "bf16")
    print(f"[b1 times] bf16 B,T,nh,hd={B1_SHAPE} (device ms, median of 20): "
          f"kernel {med['kernel']:.4f}, SDPA with the key mask "
          f"{med['library']:.4f}; bound {b_ms:.4f} by {b_by} [{card}]", flush=True)
    from mertools_tpu_torch.ops import mel
    from mertools_tpu_torch.ops import mel_fused as mf

    med = mel_times(torch, mf, mel, mel_inputs(torch), parts=False)
    b_ms, b_by, _, _ = mel_bound(mel)
    print(f"[b2 times] B=8x480000 (device ms, median of 20): kernel "
          f"{med['kernel']:.4f}, mel_power_ref {med['plain']:.4f}; bound "
          f"{b_ms:.4f} by {b_by} [{card}]", flush=True)
    return 0


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it runs only on the card",
              file=sys.stderr)
        return 1
    if argv[:1] == ["--b3-times"] and len(argv) == 2:
        return b3_times_of(torch, argv[1])
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "mertools_tpu_torch")):
        print("chip_smoke: mertools_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from mertools_tpu_torch.asr import decode as tdec
    from mertools_tpu_torch.asr import pipeline as tasr
    from mertools_tpu_torch.encoders import wav2vec2 as tw
    from mertools_tpu_torch.encoders import whisper as tws
    from mertools_tpu_torch.features import audio as ta
    from mertools_tpu_torch.mllm import affectgpt as tga
    from mertools_tpu_torch.mllm import llm as tl
    from mertools_tpu_torch.mllm import qformer as tq
    from mertools_tpu_torch.mllm import runner as tr
    from mertools_tpu_torch.ops import _kernels
    from mertools_tpu_torch.ops import flash_attention as fa
    from mertools_tpu_torch.ops import flash_attention_causal as fc
    from mertools_tpu_torch.ops import mel
    from mertools_tpu_torch.ops import mel_fused as mf

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1 device] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    path, secs, log = _kernels.build()
    usage = check_no_spills(log)
    print(f"[1 device] kernels {os.path.relpath(path, HERE)}: built in "
          f"{secs:.1f} s{'' if secs else ' (reused, with its build log)'}; "
          f"ptxas -v (registers, spill store/load bytes): {usage} [{card}]",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kres = phase_kernel(torch, fa, card)
    launches, ex_bf16, _ = phase_extract(torch, fa, ta, tw, card)
    phase_cli(torch, ex_bf16, card)
    del ex_bf16
    torch.cuda.empty_cache()

    mres = phase_mel(torch, mel, mf, card, usage)
    cfg, params, wavs, feat_launches, _ = phase_whisper_features(
        torch, mel, mf, tws, ta, card)
    asr_launches, _ = phase_asr(torch, mf, tws, tasr, tdec, cfg, params, wavs, card)
    del params
    torch.cuda.empty_cache()
    phase_cli_whisper(torch, mf, ta, card)
    torch.cuda.empty_cache()

    b3 = phase_b3(torch, fc, card)
    train_launches = phase_train(torch, fc, tga, tl, tq, tr, card)
    phase_cli_train(torch, fc, card)

    # the fusion trainer's path: counts start at 0 here and are read right
    # after it; it runs cuBLAS/cuDNN and none of the port's kernels
    wrappers = [fa.flash_attention, mf.mel_power] + [getattr(fc, n) for n in B3_WRAPPERS]
    for w in wrappers:
        w.launches = 0
    phase_fusion_hubert(torch, card)
    phase_fusion_mer2023(torch, card)
    phase_fusion_frames(torch, card)
    fusion_launches = {w.__name__: w.launches for w in wrappers}
    print(f"[12 fusion] kernel launches in phase 12: {fusion_launches} [{card}]",
          flush=True)
    check(not any(fusion_launches.values()), f"phase 12 launched {fusion_launches}")
    torch.cuda.empty_cache()

    from mertools_tpu_torch.encoders.bert import BertConfig
    from mertools_tpu_torch.encoders.vit_clip import CLIPVisionConfig

    ex_text, text_launches, b1_text = phase_text(torch, fa, BertConfig.large(), card)
    ex_vis, vision_launches, b1_vis = phase_vision(torch, fa, CLIPVisionConfig(), card)
    tri_launches, handoff = phase_trimodal(torch, fa, ex_text, ex_vis, card)
    del ex_text
    torch.cuda.empty_cache()
    face_launches = phase_faces(torch, fa, ex_vis, handoff, card)
    del ex_vis, handoff
    b1_paths = {"HuBERT (3)": launches, "MacBERT (13)": text_launches,
                "CLIP (14)": vision_launches, "trimodal (15)": tri_launches,
                "faces (16)": face_launches}
    text_ms = ", ".join(
        f"{bucket}: {r['ms']:.4f} / {r['plain_ms']:.4f} / {r['library_ms']:.4f} / "
        f"{r['bound_ms']:.4f}" for bucket, r in b1_text.items())
    print(f"[16 faces] B1 launches by path: {b1_paths}; B1 at the new "
          f"shapes (bf16 device ms, kernel / plain / SDPA / bound): MacBERT "
          f"by bucket {text_ms}; CLIP 64 x 257 {b1_vis['ms']:.4f} / "
          f"{b1_vis['plain_ms']:.4f} / {b1_vis['library_ms']:.4f} / "
          f"{b1_vis['bound_ms']:.4f} [{card}]", flush=True)

    b, m = kres["bf16"], mres
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mertools_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mertools_tpu/encoders/wav2vec2.py:160",
        "launches": sum(b1_paths.values()), "max_abs_err": b["max_abs_err"],
        "ms": b["ms"],
        "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"], "library_ms": b["library_ms"]}, {
        "name": "mel_power_fwd", "route": "cuda",
        "source": "mertools_tpu_torch/csrc/mel_power_fwd.cu",
        "replaces": "mertools_tpu/ops/mel_pallas.py:95",
        "launches": feat_launches + asr_launches, "max_abs_err": m["max_abs_err"],
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": None}]
    lib = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    for key, wrapper, replaces in (
            ("fwd", "flash_attention_causal_fwd",
             f"mertools_tpu/mllm/llm.py:194 ({lib}:758)"),
            ("prep", "flash_attention_causal_bwd_prep",
             f"mertools_tpu/mllm/llm.py:194 ({lib}:273, di of the backward)"),
            ("dkv", "flash_attention_causal_bwd_dkv",
             f"mertools_tpu/mllm/llm.py:194 ({lib}:1121)"),
            ("dq", "flash_attention_causal_bwd_dq",
             f"mertools_tpu/mllm/llm.py:194 ({lib}:1456)")):
        r = b3[key]
        kernels.append({
            "name": wrapper, "route": "cuda",
            "source": "mertools_tpu_torch/csrc/flash_attention_causal.cu",
            "replaces": replaces, "launches": train_launches[wrapper],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
