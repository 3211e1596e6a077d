#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mertools_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls, at full
published width with seeded random weights — HuBERT-large audio feature
extraction (hidden 1024, 24 layers, 16 heads), then Whisper-large-v2
features and ASR (d_model 1280, 32 + 32 layers, 20 heads, vocab 51865) —
and checks them:

1. device: the card's name and power limit; build the CUDA kernels from
   ``mertools_tpu_torch/csrc`` with nvcc (into ``build/kernels/``);
2. kernel vs plain: the flash-attention kernel against its plain PyTorch
   version at HuBERT-large shapes, fp32 and bf16, with CUDA-event times;
3. extraction: ``AudioExtractor`` on 64 clips of 2-10 s in four modes (fp32
   parity, bf16, bf16 + flash kernel, int16 wire + bf16 + flash kernel);
   clips/s, launch counts, cross-mode agreement, and fp32 against the
   per-clip CPU reference on two clips;
4. CLI: ``mertools_tpu_torch.cli.extract_audio`` on four PCM16 wavs;
5. mel kernel vs plain: the fused log-mel kernel (B2) against its plain
   version (cuFFT) at B = 8 x 30 s, with CUDA-event times;
6. Whisper features: ``WhisperAudioExtractor`` on 16 clips of 2-30 s, f32
   and int16 wires; clips/s, launch counts, kernel against plain frontend
   end to end, a profile of one batch, and the card against the CPU (2 + 2
   layers of the same weights);
7. Whisper ASR: ``WhisperASR.transcribe_batch`` on 8 clips; encode and
   decode rates, a profile of one decode, and the cached decode steps
   against the full decoder;
8. CLIs: ``extract_audio`` on Whisper (tiny random config) and
   ``main_asr merge`` / ``punctuate``.

Before each path runs, its kernels' launch counts are set to 0; they are
read right after it. It prints one JSON line about the kernels and, last, one JSON line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
Without a CUDA device, or without the package beside it, it exits 1 and
prints no result. It imports neither JAX nor ``transformers``.
"""

from __future__ import annotations

import dataclasses
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
# B2: both sides fp32, dense DFT vs cuFFT, so rounding only
MEL_TOL = 1e-5      # max |kernel - ref| / max |ref| per clip
LOG_MEL_TOL = 1e-4  # abs, in the (log10 + 4) / 4 domain


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


def phase_kernel(torch, fa, card):
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
              f"(median of 20) [{card}]", flush=True)
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


def phase_mel(torch, mel, mf, card):
    """Kernel B2 against its plain version (cuFFT + matmul) at B = 8."""
    x = mel_inputs(torch)
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
    runs = {"kernel": lambda: mf.mel_power(x),
            "plain": lambda: mf.mel_power_ref(x),
            "log_mel_fused": lambda: mf.log_mel_spectrogram_fused(x),
            "log_mel": lambda: mel.log_mel_spectrogram(x)}
    times = {n: [] for n in runs}
    for _ in range(20):  # in turns, so drift hits all alike
        for n, f in runs.items():
            times[n] += cuda_ms(torch, f, reps=1)
    med = {n: float(np.median(t)) for n, t in times.items()}
    print(f"[5 mel] B2 B=8x480000 (sine, sine+noise, noise, short noise, zero, "
          f"square, DC, DC+noise): max_abs_err={err:.3e}, worst clip "
          f"{rel:.3e} of max|ref| (limit {MEL_TOL}), log-mel max abs err "
          f"{d_log:.3e} (limit {LOG_MEL_TOL}); kernel {med['kernel']:.4f} ms, "
          f"mel_power_ref {med['plain']:.4f} ms; log_mel_spectrogram_fused "
          f"{med['log_mel_fused']:.4f} ms, log_mel_spectrogram "
          f"{med['log_mel']:.4f} ms (median of 20) [{card}]", flush=True)
    return dict(max_abs_err=err, rel_err=rel, log_err=d_log, ms=med["kernel"],
                plain_ms=med["plain"])


def whisper_clips():
    """16 clips of 2-30 s, uniform, seed 0, PCM16."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(2 * SR, 30 * SR + 1, size=16)
    wavs16 = {f"clip{i}": (rng.normal(size=int(L)) * 3000).astype(np.int16)
              for i, L in enumerate(lengths)}
    wavs = {n: w.astype(np.float32) / 32768.0 for n, w in wavs16.items()}
    return lengths, wavs16, wavs


def device_profile(torch, fn):
    """One call of fn under torch.profiler: (wall ms, device-busy ms as the
    union of device intervals, top 5 device ops by summed time in ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end, by_name = 0.0, -1.0, {}
    for a, b, name in evs:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return wall, busy / 1e3, top


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

    wall, busy, top = device_profile(
        torch, lambda: ex.extract(dict(list(wavs.items())[:8]), level="UTT"))
    top_s = ", ".join(f"{n[:60]} {t:.1f} ms" for n, t in top)
    print(f"[6 whisper] profile of one f32 batch (8 clips): wall {wall:.1f} ms, "
          f"device busy {busy:.1f} ms, idle share "
          f"{1 - busy / wall if busy else float('nan'):.3f}; top device ops: "
          f"{top_s} [{card}]", flush=True)

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
    wall_d, busy_d, top_d = device_profile(torch, lambda: tdec.greedy_decode(
        cfg, asr.model, enc, prompt, P, max_new))
    top_s = ", ".join(f"{n[:60]} {t:.1f} ms" for n, t in top_d)
    print(f"[7 asr] profile of one decode ({L - 1} steps, B = {B}): wall "
          f"{wall_d:.1f} ms, device busy {busy_d:.1f} ms, idle share "
          f"{1 - busy_d / wall_d if busy_d else float('nan'):.3f}; top device "
          f"ops: {top_s} [{card}]", flush=True)

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
    from mertools_tpu_torch.asr import decode as tdec
    from mertools_tpu_torch.asr import pipeline as tasr
    from mertools_tpu_torch.encoders import wav2vec2 as tw
    from mertools_tpu_torch.encoders import whisper as tws
    from mertools_tpu_torch.features import audio as ta
    from mertools_tpu_torch.ops import _kernels
    from mertools_tpu_torch.ops import flash_attention as fa
    from mertools_tpu_torch.ops import mel
    from mertools_tpu_torch.ops import mel_fused as mf

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1 device] {kind}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    path, secs, log = _kernels.build()
    ptxas = [l.strip() for l in log.splitlines() if "registers" in l]
    print(f"[1 device] kernels {os.path.relpath(path, HERE)}: built in "
          f"{secs:.1f} s{'' if secs else ' (reused)'}; ptxas: {ptxas} [{card}]",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kres = phase_kernel(torch, fa, card)
    launches, ex_bf16, _ = phase_extract(torch, fa, ta, tw, card)
    phase_cli(torch, ex_bf16, card)
    del ex_bf16
    torch.cuda.empty_cache()

    mres = phase_mel(torch, mel, mf, card)
    cfg, params, wavs, feat_launches, _ = phase_whisper_features(
        torch, mel, mf, tws, ta, card)
    asr_launches, _ = phase_asr(torch, mf, tws, tasr, tdec, cfg, params, wavs, card)
    del params
    torch.cuda.empty_cache()
    phase_cli_whisper(torch, mf, ta, card)

    b = kres["bf16"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mertools_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mertools_tpu/encoders/wav2vec2.py:160",
        "launches": launches,
        "max_abs_err": b["max_abs_err"],
        "ms": b["ms"],
        "plain_ms": b["plain_ms"]}, {
        "name": "mel_power_fwd",
        "route": "cuda",
        "source": "mertools_tpu_torch/csrc/mel_power_fwd.cu",
        "replaces": "mertools_tpu/ops/mel_pallas.py:95",
        "launches": feat_launches + asr_launches,
        "max_abs_err": mres["max_abs_err"],
        "ms": mres["ms"],
        "plain_ms": mres["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
