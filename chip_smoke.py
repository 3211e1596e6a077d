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
24 layers, projection 768), MER2023's trimodal pipeline, the face
frontend that makes its face stores from frames, AffectGPT generation
and serving at TinyLlama-1.1B width, e2e fine-tuning of HuBERT-large with
the int8 extraction mode, the audio encoder zoo (VGGish, wav2vec 1.0,
emotion2vec base, ImageBind-huge audio), the handcrafted acoustic
sets (librosa mel/MFCC, openSMILE IS09, IS10, IS13 and eGeMAPS) and the
ViT vision zoo (DINOv2-large, data2vec-vision-base, VideoMAE-large,
SigLIP-so400m, EVA-CLIP-G) — and checks them; a ``[time]`` line after each
phase gives its seconds:

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
   3 epochs: cv WAF, seconds a fold and an epoch, steps/s, and the device
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
   the kernels line;
17. the fusion zoo at MER2023's split sizes, each model at the
   hyperparameters ``--seed=0`` draws from ``train/model_tune.yaml``, every
   run cut to 1 epoch and 2 folds (``ZOO_EPOCHS``, ``ZOO_FOLDS``), MulT to
   2 layers (``ZOO_DEPTH``): (a)
   ``main_release`` for lf_dnn, tfn, lmf, misa and mmim on UTT stores
   (1024/1024/768), for ef_lstm, mfn, graph_mfn, mfm and mctn on
   frm_align stores with 12c's frame spans, and mult on frm_unalign: cv
   WAF and emoval, the first fold's seconds and training steps/s, and the
   device idle share of the run's last epoch under the profiler; (b) each
   model against the CPU from the same weights as 12c (dropout off, MFM's
   prior drawn once for both; each gradient tensor against its own max, at
   least 1e-3 of the model's largest, MulT on frm_unalign against the
   largest itself);
   (c) top-N fusion (``--fusion_topn=6``, AVT, ``attention_topn``) on 18
   UTT stores at their encoders' widths, the same numbers; (d)
   ``cli.sweep --n_search=2 --n_repeat=2`` over 12b's attention flags,
   checked to carry the winner's hyperparameters into the repeats and to
   print a JSON line. It launches none of the port's kernels;
18. serving at TinyLlama-1.1B width (11 of its 22 layers, ``SERVE_DEPTH``)
   with AffectGPT's LoRA r 16: (a)
   ``generate`` (KV cache, greedy) on 8 ragged prompts of 64-448 tokens,
   bf16: prefill ms, a decode step's ms and tokens/s from the marginal
   rate of 64 and 128 new tokens (guarded: the longer call must take
   longer), peak memory, one profiled decode step's idle share beside its
   bytes bound, then w8 weights, int8 KV and both; at full width and 2
   layers in fp32, the cached decode against ``LLM.forward``, w8 against
   its dequantized weights, int8 KV against full precision and the card
   against the CPU; (b) ``ContinuousBatcher`` on 64 token-id requests of
   16-448 tokens with budgets of 16-128, 16 slots, chunks of 32, bf16:
   requests/s, tokens/s, a profiled chunk's idle share, and at 2 layers in
   fp32 each request against ``generate`` on its prompt alone, without and
   with a 32-token shared prefix; (c) ``beam_generate`` (4 beams, B 2, 32
   tokens) on the card against the CPU; (d) ``inference_mllm`` on 16 clips
   of CLIP-L and HuBERT FRA stores from a ``save_model`` AffectGPT, card
   against CPU, and ``ovlabel_extraction --engine=continuous --w8 --bf16``
   and ``translate`` on a written HF-layout directory, through a
   character-level stand-in tokenizer. It launches none of the port's
   kernels (counted): the JAX serving path reaches no Pallas kernel;
19. e2e fine-tuning and the int8 extraction mode: (a) ``main_release
   --model=e2e_model --e2e_name=chinese-hubert-large --savemodel`` at
   published width (12 of its 24 layers, ``E2E_LAYERS``, hidden 1024, 16
   heads; seeded weights written
   as ``config.json`` + ``pytorch_model.bin``) on 256 wavs of 2-6 s in two
   tone classes, 8 x 32000 samples a clip, batch 32 (16 if 32 runs out of
   memory, said so), 2 folds x 2 epochs: seconds a step, segments/s, peak
   memory, the last training epoch's idle share under the profiler; the
   losses finite and the saved backbone moved; the card against the CPU
   from the same weights at 2 layers (a step's gradients, a trained model's
   test logits); (b) ``extract_audio --finetuned_ckpt`` on the fold-0
   backbone against the saved encoder, and a half-width checkpoint refused;
   (c) ``e2e_model`` on MacBERT-large (3 layers, the stand-in tokenizer) and
   CLIP-L/14 (2 layers, uint8 112 x 112 crops), one fold x one epoch, card
   against CPU from the same weights; (d) HuBERT-large (its 12 layers) on the bench mix and
   CLIP-L on phase 14's clips at fp32, bf16 and int8 (clips/s, frames/s, the
   UTT gate int8 vs fp32 <= 3 x bf16 vs fp32), and the int8 sites' codes,
   scales and products card against CPU at 2 layers. It launches none of
   the port's kernels (counted): the JAX e2e encoders run without flash
   attention and the int8 product is an XLA dot.
20. the audio encoder zoo behind ``extract_audio`` at published width with
   seeded weights: VGGish, wav2vec 1.0 (``Wav2Vec1Config()``), emotion2vec
   base and ImageBind-huge audio (Kaldi fbank): (a) each extractor on
   phase 3's 64 clips plus 4 of 20-45 s, UTT and FRA: clips/s, peak memory,
   a profiled batch's idle share, FRA rows by the trim rules; (b) the card
   against the CPU from the same weights (emotion2vec 1 + 1 blocks,
   ImageBind 2 blocks) on 4 clips; (c) rows of a ragged bucketed batch
   against each clip alone, for emotion2vec and wav2vec 1.0; (d)
   ``extract_audio`` on a reference-layout checkpoint file of each family
   (a torchvggish ``.pt``, a fairseq ``.pt`` writing the z and c stores, a
   funasr ``.pt`` with EMA keys, an ``imagebind_huge.pth``) against the
   extractor on the same weights. It launches none of the port's kernels
   (counted): the JAX zoo's attention is a dense einsum and its spectra
   ``jnp.fft``;
21. the handcrafted sets behind ``extract_handcrafted`` (librosa mel_spec
   and mfcc, openSMILE IS09, IS10, IS13 and eGeMAPS; fp32, TF32 off): (a)
   each set at UTT and FRA through ``extract_batch`` on phase 3's 64 clips
   plus 4 of 20-30 s (the CLI's buckets to 30 s, batch 32): clips/s (median
   of 3 passes), peak memory, stores finite at their dims and FRA rows by
   the JAX rules, then IS13's 12 s bucket under the profiler (idle share,
   top device ops, the Viterbi and RASTA loops' shares); (b)
   four tone clips on the card against the CPU (1e-4 of each column's max,
   discrete columns equal; IS10's and IS13's functionals off it printed
   with the account ``hc_explain`` gives them), the CPU's clips/s beside
   the card's; (c) a ragged 6 s bucket against each clip alone (the
   openSMILE sets, 1e-5 of max |clip|; the librosa sets printed);
   (d) ``extract_handcrafted.main`` on 16 wavs it writes, each store equal
   to ``extract_batch``. It launches none of the port's kernels (counted):
   the JAX chains' spectra are ``jnp.fft`` and their products einsums;
22. the ViT vision zoo behind ``extract_vision`` at published width with
   seeded weights: DINOv2-large (518 px, 1,370 tokens), data2vec-vision-base
   (per-layer relative bias), VideoMAE-large (16 frames, 1,568 tokens),
   SigLIP-so400m (384 px) and EVA-CLIP-G (39 x 1408), on 16 clips of 8-80
   face crops (112 x 112 BGR uint8): (a) bf16 on the whole mix and fp32
   (TF32 off) on one batch of 64 frames (8 clips for VideoMAE), UTT and
   FRA: frames/s (clips/s), the median of 3 passes, peak memory, a batch's
   profile; (b) the card against the CPU in fp32 at 2 layers of full width
   on 4 clips; (c) bf16 UTT within 3% of fp32; (d) ToMe r 8 for DINOv2,
   SigLIP and EVA-CLIP-G beside the full tower; (e) ``extract_vision.main``
   on a checkpoint in the publisher's layout (``config.json`` +
   ``pytorch_model.bin``; ``eva-clip-g.pth``), DINOv2 at full depth in bf16
   and the others at 2 layers, each store equal to the library call. It
   launches none of the port's kernels (counted): the JAX ViTs' attention
   is a dense einsum.

    python3 chip_smoke.py --fusion-zoo

runs phase 17 alone (its kernel counts included),

    python3 chip_smoke.py --serving

runs phase 18 alone (its kernel counts included),

    python3 chip_smoke.py --e2e

runs phase 19 alone (its kernel counts included),

    python3 chip_smoke.py --audio-zoo

runs phase 20 alone (its kernel counts included),

    python3 chip_smoke.py --handcrafted

runs phase 21 alone (its kernel counts included),

    python3 chip_smoke.py --vision-zoo

runs phase 22 alone (its kernel counts included), and

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
import contextlib
import copy
import csv
import dataclasses
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# phase 21's comparison rule, shared with the CPU tests that hold the port
# to the JAX package by it
sys.path.insert(0, os.path.join(HERE, "tests"))
from hc_gates import (HC_RAGGED_TOL, hc_explain, hc_gate,  # noqa: E402,F401
                      hc_columns, port_engine)
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


def device_events(torch, fn):
    """One call of fn under torch.profiler: (wall ms, the device timeline's
    events as (start us, end us, name, kind) tuples, kind "device" for
    kernels, memcpys and memsets and "annotation" for a host range the
    profiler draws there, ``FunctionEvent.is_user_annotation``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, [(e.time_range.start, e.time_range.end, e.name,
                   "annotation" if e.is_user_annotation else "device")
                  for e in prof.events() if e.device_type == DeviceType.CUDA]


def profile_summary(evs):
    """(device-busy ms by :func:`busy_ms`, top 5 device ops by summed time
    in ms, ms of each host range left out, the busy ms had those ranges
    counted too) of :func:`device_events`' events."""
    by_kind = {"device": {}, "annotation": {}}
    for a, b, name, kind in evs:
        by_kind[kind][name] = by_kind[kind].get(name, 0.0) + (b - a) / 1e3
    top = sorted(by_kind["device"].items(), key=lambda kv: -kv[1])[:5]
    with_ranges = busy_ms([(a, b, n, "device") for a, b, n, _ in evs])
    return busy_ms(evs), top, by_kind["annotation"], with_ranges


def device_profile(torch, fn):
    """One call of fn under torch.profiler: (wall ms, then
    :func:`profile_summary`'s four numbers)."""
    wall, evs = device_events(torch, fn)
    return (wall, *profile_summary(evs))


def linked_busy_ms(ops, spans) -> tuple[float, dict]:
    """Device ms of the kernels, memcpys and memsets that the host ops
    inside any of ``spans`` (start, end us on the host clock) launched, in
    all and by name. The profiler links each device event to the op that
    launched it, so this needs no alignment of the device's clock with the
    host's; on one stream the sum is the busy time."""
    by = {}
    for e in ops:
        if e.kernels and any(a <= e.time_range.start and e.time_range.end <= b for a, b in spans):
            for k in e.kernels:
                by[k.name] = by.get(k.name, 0.0) + k.duration / 1e3
    return sum(by.values()), by


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
                         epochs: int = 3):
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


def same_weights_check(torch, args, sets: dict, dev: str, rng, epochs: int = 2,
                       prepare=None, floor: float = 0.0, worst: dict | None = None,
                       batch_size: int = 32):
    """The card against the CPU where both start from the same weights (a
    fresh fold model, seed 0): every gradient of one training step on the
    first batch (``batch_size`` rows) of ``sets["train"]``, then the test1
    logits and valence of the model the card trained for ``epochs`` epochs
    (batch orders from ``rng``), evaluated on both. ``prepare(model)`` runs
    on both copies first (phase 17: dropout off, MFM's prior fixed; phase
    19: dropout off, the pretrained backbone loaded). Returns the two
    max |card - cpu| / max |cpu|; a gradient's max |cpu| counts as at least
    ``floor`` of the largest over the model (phase 17: ``ZOO_GRAD_FLOOR``).
    ``worst`` (a dict) gets the gradient with the largest ratio: its name,
    the ratio and its own max |cpu| over the largest."""
    from mertools_tpu_torch.core.device import resolve_device
    from mertools_tpu_torch.data.dataset import epoch_plan
    from mertools_tpu_torch.train import loop

    n_train, n_test = len(sets["train"]), len(sets["test1"])
    devs = {"card": resolve_device(dev, fp32=True), "cpu": torch.device("cpu")}
    idx, mask = epoch_plan(np.arange(n_train), batch_size, np.random.default_rng(0))
    sample = {k: v[idx[0]] for k, v in sets["train"].arrays().items()}
    models = {"cpu": loop.init_model(args, sample, torch.Generator().manual_seed(0))}
    models["card"] = copy.deepcopy(models["cpu"]).to(devs["card"])
    for m in models.values():
        if prepare is not None:
            prepare(m)
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
    largest = max(float(g.abs().max()) for g in grads["cpu"].values())
    ratios = {n: float((grads["card"][n] - g).abs().max() / max(float(g.abs().max()),
                                                               floor * largest))
              for n, g in grads["cpu"].items()}
    name = max(ratios, key=ratios.get)
    d_grad = ratios[name]
    if worst is not None:
        worst.update(tensor=name, ratio=d_grad, share=float(grads["cpu"][name].abs().max())
                     / largest, floor=floor)
    opt = loop.ClippedAdam(models["card"].parameters(), lr=1e-3)
    for _ in range(epochs):
        plan = epoch_plan(np.arange(n_train), batch_size, rng)
        loop.train_epoch(models["card"], opt, data["card"]["train"].data,
                         *(torch.from_numpy(x).to(devs["card"]) for x in plan),
                         None, True, True)
    models["cpu"].load_state_dict(models["card"].state_dict())
    test_plan = epoch_plan(np.arange(n_test), batch_size)
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
    pad_token_id = 0

    def __call__(self, text: str) -> dict:
        return {"input_ids": self.encode(text)}

    def encode(self, text: str, add_special_tokens: bool = True) -> list:
        # a CJK character keeps its place; any other wraps into the range
        ids = [(ord(c) - self.FIRST_CHAR) % self.N_CHARS + self.FIRST_ID for c in text]
        return [self.CLS] + ids + [self.SEP] if add_special_tokens else ids

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


# ------------------------------------------------------ fusion zoo (17)
ZOO_UTT = ("lf_dnn", "tfn", "lmf", "misa", "mmim")
# MulT runs on frm_unalign only: its frm_align run (67 s of CLI time on
# an H100 80GB HBM3 at 700 W) was cut for phase 18's time; the five models
# above cover the frm_align path
ZOO_FRM = ("ef_lstm", "mfn", "graph_mfn", "mfm", "mctn")
# epochs a main_release run (the reference runs 100), cut to fit the phase
ZOO_EPOCHS = {"utt": 1, "frm": 1, "topn": 1, "sweep": 1}
# the card-vs-CPU step's gradients: each tensor is held to its own max
# |cpu|, counted as at least this share of the model's largest gradient
# (see same_weights_check), the tier-1 zoo test's floor: a gradient that is
# 0 in exact arithmetic (a key bias under softmax) is rounding noise
ZOO_GRAD_FLOOR = 1e-3
# held to the model's largest gradient itself: MulT on frm_unalign carries
# fp32 rounding on the CPU alone (fp32 against fp64 from the same weights)
# of 9.0e-3 of trans_l_with_a.fc1_5.weight's own max, 3.1e-5 of the
# largest, and the JAX package the same (ROADMAP §C)
ZOO_GRAD_FLOOR_WIDE = {("mult", "frm_unalign"): 1.0}
# folds of a main_release run: MER2023's protocol has 5 (the loader's
# num_folder); fewer is a cut of the phase's time, set on the loader class
ZOO_FOLDS = {"utt": 2, "frm": 2, "topn": 2, "sweep": 2}
# the sweep's search draws and repeats (MERBench runs 50 and 6): cut from
# 3 draws to 2 for phase 18's time
ZOO_SWEEP = {"n_search": 2, "n_repeat": 2}
# depth cut of a run, over its seed-0 draw: MulT's draw stacks 6 layers in
# each of its crossmodal and self-attention transformers, and its
# frm_unalign run took 50.6 s of phase 17's 265.6 s (the CLI; NVIDIA H100
# 80GB HBM3, 700 W); 2 layers make room for phase 22
ZOO_DEPTH = {"mult": {"layers": 2}}
# 12c's frame spans (store, width, fewest and most frames) at feat_scale 6,
# written as main_release's compression leaves them: ceil(T / 6) frames a
# clip, read at --feat_scale=1 (frm_align) or 2 (frm_unalign: 12 / 6), so
# the models see 12c's lengths from a sixth of the bytes
FRM_FEATURES = (("chinese-hubert-large-FRA", 1024, 100, 500),
                ("chinese-macbert-large-FRA", 1024, 16, 64),
                ("clip-vit-large-patch14-FRA", 768, 50, 250))
FRM_SCALE = 6
# the UTT width of each encoder in the top 6 of the rank lists, from the
# port's or the JAX package's encoder configs, else as noted
TOPN_WIDTHS = {
    "whisper-base": 512,                    # mertools_tpu/encoders/whisper.py:30
    "chinese-wav2vec2-large": 1024,         # mertools_tpu/encoders/wav2vec2.py:69
    "wavlm-large": 1024,                    # the same large geometry
    "whisper-large-v2": 1280,               # phase 6's d_model
    "chinese-hubert-base": 768,             # mertools_tpu/encoders/wav2vec2.py:36
    "chinese-hubert-large": 1024,           # phase 3
    "xlm-roberta-large": 1024,              # BERT-large geometry (published config)
    "chinese-roberta-wwm-ext": 768,         # mertools_tpu_torch/encoders/bert.py:56
    "chinese-macbert-base": 768,            # the same
    "chinese-macbert-large": 1024,          # BertConfig.large (phase 13)
    "chinese-roberta-wwm-ext-large": 1024,  # the same
    "baichuan2-7b-base": 4096,              # Baichuan2-7B's published hidden_size
    "eva02-base-patch14-224": 768,          # mertools_tpu/encoders/vit.py:38
    "manet": 1024,                          # mertools_tpu/features/vision_zoo.py:268
    "resnet-msceleb": 2048,                 # mertools_tpu/encoders/resnet.py:112
    "dinov2-large": 1024,                   # ViT-L hidden (published config)
    "clip-vit-base-patch32": 512,           # mertools_tpu_torch/encoders/vit_clip.py:42
    "clip-vit-large-patch14": 768,          # projection 768 (phase 14)
}


@contextlib.contextmanager
def mer2023_folds(n: int, loader: str = "MER2023Loader"):
    """MER2023's loader (or ``loader``, e.g. MER2025's) makes ``n`` folds
    while the block runs."""
    from mertools_tpu_torch.data import loaders

    cls = getattr(loaders, loader)
    was = cls.num_folder
    cls.num_folder = n
    try:
        yield
    finally:
        cls.num_folder = was


def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept out of the log (each
    ``main_release`` prints its args and every fold); returns the result
    and what it printed."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def write_store(root: str, names, rows) -> None:
    """One ``.npy`` a clip under ``root`` (the reference layout), written
    by 8 threads: each write waits on the card machine's 9p file system
    with the GIL released."""
    from concurrent.futures import ThreadPoolExecutor

    from mertools_tpu_torch.data import feature_store

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda nr: feature_store.write_feature(root, *nr), zip(names, rows)))


def write_topn_stores(fdir: str, names, emos, specs) -> None:
    """Phase 17c's UTT stores under ``fdir`` for ``specs`` of (encoder,
    width, seed), each drawn by ``fusion_features`` from its own seed (the
    parent draws the same rows); run in a child process."""
    from mertools_tpu_torch.core.globals_mer import feature_dir_name

    t0 = time.perf_counter()
    for f, dim, seed in specs:
        write_store(os.path.join(fdir, feature_dir_name(f, "UTT")), names,
                    fusion_features(np.random.default_rng(seed), emos, dim))
    print(f"[17 zoo] c: a child process wrote top-N's {len(specs)} stores of "
          f"{len(names)} clips in {time.perf_counter() - t0:.1f} s", flush=True)


def frm_features(rng, emos, dim: int, lo: int, hi: int, scale: int = FRM_SCALE):
    """Ragged (ceil(T / scale), dim) class-separable frames a clip, T drawn
    from [lo, hi]: a seeded centre a class plus unit noise cut from one
    seeded bank."""
    centres = rng.normal(size=(6, dim)).astype(np.float32) * 0.3
    bank = rng.normal(size=(4096, dim)).astype(np.float32)
    lens = -(-rng.integers(lo, hi + 1, len(emos)) // scale)
    offs = rng.integers(0, len(bank) - lens.max(), len(emos))
    return [centres[e] + bank[o:o + n] for e, o, n in zip(emos, offs, lens)]


def zoo_flags(d: str, model: str, feat_type: str, epochs: int, dev: str, *extra):
    """``main_release`` flags for MER2023 on phase 17's stores under ``d``."""
    feats = ([f for f, _ in FUSION_FEATURES] if feat_type == "utt"
             else [f for f, *_ in FRM_FEATURES])
    scale = {"utt": [], "frm_align": ["--feat_scale=1"],
             "frm_unalign": ["--feat_scale=2"]}[feat_type]
    return ["--dataset=MER2023", f"--audio_feature={feats[0]}",
            f"--text_feature={feats[1]}", f"--video_feature={feats[2]}",
            f"--feat_type={feat_type}", f"--model={model}", "--seed=0",
            "--batch_size=32", f"--epochs={epochs}",
            f"--features_root={os.path.join(d, 'features')}",
            f"--label_path={os.path.join(d, 'label.npz')}",
            f"--save_root={os.path.join(d, 'saved', f'{model}_{feat_type}')}",
            *scale, *extra, "--device", dev]


def seed0_hp(model: str) -> dict:
    """The hyperparameters ``main_release --seed=0`` draws for ``model``."""
    from mertools_tpu_torch.cli import main_release
    from mertools_tpu_torch.core.config import load_yaml, random_select

    return random_select(load_yaml(os.path.normpath(main_release._TUNE_YAML))[model],
                         np.random.default_rng(0))


def epoch_busy(torch, fn) -> tuple[float, float, int]:
    """One call of ``fn`` under ``torch.profiler`` tracing the card only:
    (wall ms, device-busy ms by :func:`busy_ms`, device events). Reads the
    profiler's raw events, which an epoch of a recurrent model yields by
    the hundred thousand."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    starts, ends = [], []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA
                or getattr(e, "is_user_annotation", lambda: False)()):
            continue
        a = e.start_ns() / 1e3 if hasattr(e, "start_ns") else e.start_us()
        starts.append(a)
        ends.append(a + (e.duration_ns() / 1e3 if hasattr(e, "duration_ns")
                         else e.duration_us()))
    return wall, union_ms(np.array(starts), np.array(ends)), len(starts)


def union_ms(starts_us: np.ndarray, ends_us: np.ndarray) -> float:
    """:func:`busy_ms` of device intervals given as arrays (µs): the length
    of their union, in ms, vectorised for the 10^5-10^6 intervals of an
    epoch."""
    if not len(starts_us):
        return 0.0
    order = np.argsort(starts_us, kind="stable")
    s, e = starts_us[order], ends_us[order]
    before = np.concatenate([[-np.inf], np.maximum.accumulate(e)[:-1]])
    return float(np.clip(e - np.maximum(s, before), 0.0, None).sum() / 1e3)


class RunProbe:
    """While active, a ``run_cv`` runs as it does, but: each fold's start
    is timed (``loop.init_model`` is called once a fold), and the ``n``-th
    ``loop.run_epoch`` call (the run's last epoch: folds x epochs) runs
    under :func:`epoch_busy` on a card, or is timed alone on the CPU.
    ``prof`` is then (wall ms, busy ms, device events) and
    :meth:`first_fold_s` the first fold's seconds, which no profiler
    touched. The phase measures the run's own epoch, so no extra epoch is
    trained for the profile."""

    def __init__(self, torch, n: int):
        self.torch, self.n, self.prof, self.starts = torch, n, None, []

    def first_fold_s(self) -> float:
        return self.starts[1] - self.starts[0]

    def __enter__(self):
        from mertools_tpu_torch.train import loop

        self.loop, self.orig = loop, (loop.run_epoch, loop.init_model)
        self.calls = 0

        def init_model(*args, **kw):
            self.starts.append(time.perf_counter())
            return self.orig[1](*args, **kw)

        def run_epoch(model, *args, **kw):
            self.calls += 1
            if self.calls != self.n:
                return self.orig[0](model, *args, **kw)
            out = []
            if next(model.parameters()).is_cuda:
                self.prof = epoch_busy(self.torch, lambda: out.append(
                    self.orig[0](model, *args, **kw)))
            else:
                t0 = time.perf_counter()
                out.append(self.orig[0](model, *args, **kw))
                self.prof = ((time.perf_counter() - t0) * 1e3, float("nan"), 0)
            return out[0]

        loop.run_epoch, loop.init_model = run_epoch, init_model  # run_cv calls them by name
        return self

    def __exit__(self, *exc):
        self.loop.run_epoch, self.loop.init_model = self.orig


def zoo_card_vs_cpu(torch, model: str, hp: dict, sets: dict, dev: str, feat_type: str,
                    worst: dict | None = None):
    """12c's check for ``model`` at ``hp`` with every dropout off (MISA's
    transformer layer too) and MFM's four prior samples drawn once on the
    CPU and handed to both sides: (a step's gradients, a trained model's
    test logits), max |card - cpu| / max |cpu|, each gradient tensor at the
    floor ``ZOO_GRAD_FLOOR_WIDE`` or ``ZOO_GRAD_FLOOR`` gives it; ``worst``
    gets the gradient that sets the first number."""
    from mertools_tpu_torch.core.config import Args
    from mertools_tpu_torch.models.modules import Dropout

    args = Args(model=model, feat_type=feat_type, output_dim1=6, output_dim2=1,
                l2=1e-5, batch_size=32, **dict(hp, dropout=0.0))
    prior = [torch.randn(32, hp["hidden_dim"], generator=torch.Generator().manual_seed(170 + i))
             for i in range(4)]

    def prepare(m):
        for mod in m.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
        if hasattr(m, "prior_samples"):
            m.prior_samples = prior

    floor = ZOO_GRAD_FLOOR_WIDE.get((model, feat_type), ZOO_GRAD_FLOOR)
    return same_weights_check(torch, args, sets, dev, np.random.default_rng(0),
                              prepare=prepare, floor=floor, worst=worst)


def zoo_sets(rng, feat_type: str, n: dict):
    """Seeded FeatureDatasets of ``n[split]`` clips at the published widths
    (12c's frame spans, compressed, for the frame-level types)."""
    from mertools_tpu_torch.data.dataset import FeatureDataset

    out = {}
    for split, k in n.items():
        emos = rng.integers(0, 6, k)
        if feat_type == "utt":
            raw = [[x[None] for x in fusion_features(rng, emos, dim)]
                   for _, dim in FUSION_FEATURES]
        else:
            raw = [frm_features(rng, emos, dim, lo, hi) for _, dim, lo, hi in FRM_FEATURES]
        out[split] = FeatureDataset.from_raw(
            [f"{split}{i}" for i in range(k)], emos, (emos - 2.5) / 2.5, *raw,
            feat_type=feat_type, feat_scale=2 if feat_type == "frm_unalign" else 1)
    return out


def fold_steps(n_train: int, epochs: int, folds: int, batch: int = 32) -> int:
    """Training steps of the first fold of a ``run_cv`` (it trains on all
    chunks but the first, of n // folds)."""
    return math.ceil((n_train - n_train // folds) / batch) * epochs


def zoo_line(label: str, res, secs: float, probe, n_train: int, epochs: int, folds: int,
             d_grad, d_eval, card: str, t_check: float, worst: dict) -> str:
    """How a phase-17 run went: its cv metrics, the first fold's seconds
    and training steps/s, the profiled last epoch and the card against the
    CPU."""
    from mertools_tpu_torch.ops.metrics import overall_metric

    wall, busy, n_ev = probe.prof
    fold_s = probe.first_fold_s()
    emoval = overall_metric(res.cv["emofscore"], res.cv["valmse"])
    return (f"[17 zoo] {label}: {epochs} epoch(s) x {folds} folds, cv WAF "
            f"{res.cv['emofscore']:.4f}, emoval {emoval:.4f}; the first fold "
            f"{fold_s:.3f} s, {fold_steps(n_train, epochs, folds) / fold_s:.1f} "
            f"training steps/s (eval, tests and host metrics included); run_cv "
            f"{res.duration:.1f} s, the CLI {secs:.1f} s ({secs - res.duration:.1f} "
            f"outside run_cv: reading the stores, writing the results); the last "
            f"epoch under the profiler: wall {wall:.1f} ms, device busy {busy:.1f} "
            f"ms, idle share {1 - busy / wall:.3f} ({n_ev} device events); card vs "
            f"CPU from the same weights: a step's gradients {d_grad:.3e} (each "
            f"tensor's own max, at least {worst.get('floor')} of the largest; worst "
            f"{worst.get('tensor')}, its max {worst.get('share', float('nan')):.2e} of the "
            f"largest), test1 logits and valence after 2 epochs {d_eval:.3e} (limit "
            f"{FUSION_TOL}; {t_check:.1f} s) [{card}]")


def zoo_release(torch, flags: list, n_calls: int):
    """``main_release`` quietly under a :class:`RunProbe`: (result, CLI s,
    probe)."""
    from mertools_tpu_torch.cli import main_release

    t0 = time.perf_counter()
    with RunProbe(torch, n_calls) as probe:
        res, _ = quiet(main_release.main, flags)
    return res, time.perf_counter() - t0, probe


def phase_fusion_zoo(torch, card, dev: str = "cuda", splits=MER2023_SPLITS,
                     epochs=ZOO_EPOCHS, folds=ZOO_FOLDS):
    """17: every other fusion model of the zoo through ``main_release`` at
    MER2023's split sizes with its ``--seed=0`` hyperparameters: (a) the
    utt models on UTT stores at 1024/1024/768, the recurrent models on
    frm_align stores with 12c's frame spans, MulT on frm_unalign; cv WAF and emoval, s a fold, steps/s and the idle share
    of the run's last epoch under the profiler; (b) each against the CPU
    from the same weights (12c's check, dropout off); (c) top-N fusion
    (``--fusion_topn=6``, AVT, ``attention_topn``) on 18 UTT stores at their
    encoders' widths, the same numbers; (d) ``cli.sweep`` (``ZOO_SWEEP``'s
    draws and repeats) over 12b's attention flags with the hyperparameters left
    to the search. ``epochs`` and ``folds`` (by group) are the phase's cuts
    of the protocol's 100 epochs and 5 folds."""
    from mertools_tpu_torch.cli import main_release, sweep
    from mertools_tpu_torch.core.globals_mer import feature_dir_name
    from mertools_tpu_torch.data import labels
    from mertools_tpu_torch.data.dataset import TopNFeatureDataset

    t_phase = time.perf_counter()
    if dev == "cuda":  # cuBLAS and cuDNN set up before any fold is timed
        x = torch.ones(2, 4, 8, device=dev)
        torch.nn.LSTM(8, 8).to(dev)(x)[0].sum().item()
    rng = np.random.default_rng(17)
    corpora, emos = fusion_labels(
        rng, {s: [f"{s}_{i:05d}" for i in range(n)] for s, n in splits.items()})
    names = [n for c in corpora.values() for n in c]
    all_emos = np.concatenate(list(emos.values()))
    n_train = splits["train"]
    small = {"train": min(200, n_train // 2), "test1": min(40, n_train // 4)}
    results = {}
    gates = []   # (run, gradients, logits, worst gradient): judged after every run

    def record(key, res, probe, group):
        fold_s = probe.first_fold_s()
        results[key] = dict(wall=probe.prof[0], busy=probe.prof[1], fold_s=fold_s,
                            steps_s=fold_steps(n_train, epochs[group], folds[group]) / fold_s,
                            waf=res.cv["emofscore"])

    with tempfile.TemporaryDirectory() as d:
        fdir = os.path.join(d, "features")
        t0 = time.perf_counter()
        utt = {f: fusion_features(rng, all_emos, dim) for f, dim in FUSION_FEATURES}
        frm = {f: frm_features(rng, all_emos, dim, lo, hi) for f, dim, lo, hi in FRM_FEATURES}
        for f, rows in list(utt.items()) + list(frm.items()):
            write_store(os.path.join(fdir, f), names, rows)
        labels.write_label_archive(os.path.join(d, "label.npz"), corpora)
        frm_gb = sum(x.nbytes for rows in frm.values() for x in rows) / 1e9
        del frm
        print(f"[17 zoo] wrote MER2023-size stores ({len(names)} clips): UTT "
              f"{', '.join(f'{f} ({dim})' for f, dim in FUSION_FEATURES)}; FRA "
              f"{', '.join(f'{f} ({dim}, {lo}-{hi} frames / {FRM_SCALE})' for f, dim, lo, hi in FRM_FEATURES)}"
              f", {frm_gb:.2f} GB; {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
        # (c)'s stores that (a) has not written: a child process writes them
        # while (a)-(b) train (spawned, as this process runs CUDA and
        # threads; a daemon, so a failing phase stops it)
        fnames = TopNFeatureDataset.feature_names(6, "AVT")
        specs = [(f, TOPN_WIDTHS[f], 170 + i) for i, f in enumerate(fnames)
                 if feature_dir_name(f, "UTT") not in utt]
        writer = multiprocessing.get_context("spawn").Process(
            target=write_topn_stores, args=(fdir, names, all_emos, specs), daemon=True)
        writer.start()

        runs = [(m, "utt") for m in ZOO_UTT] + [(m, "frm_align") for m in ZOO_FRM]
        runs.append(("mult", "frm_unalign"))
        for model, feat_type in runs:
            group = "utt" if feat_type == "utt" else "frm"
            ep, nf = epochs[group], folds[group]
            depth = ZOO_DEPTH.get(model, {})
            with mer2023_folds(nf):
                res, secs, prof = zoo_release(torch, zoo_flags(
                    d, model, feat_type, ep, dev, *(f"--{k}={v}" for k, v in depth.items())),
                    ep * nf)
            for s in ("test1", "test2", "test3"):
                got = res.test_results[s]["emoprobs"]
                check(got.shape == (splits[s], 6) and bool(np.isfinite(got).all()),
                      f"17 {model} {feat_type} {s} logits {got.shape} or non-finite")
            check(all(np.isfinite(v) for v in res.cv.values() if np.ndim(v) == 0),
                  f"17 {model} {feat_type} cv {res.cv}")
            hp = {**seed0_hp(model), **depth}
            t0 = time.perf_counter()
            worst = {}
            d_grad, d_eval = zoo_card_vs_cpu(torch, model, hp, zoo_sets(
                np.random.default_rng(18), feat_type, small), dev, feat_type, worst)
            print(zoo_line(f"a/b: {model} {feat_type} (hidden {hp['hidden_dim']}, "
                           f"seed-0 draw {hp}{f', depth cut to {depth}' if depth else ''})",
                           res, secs, prof, n_train, ep, nf,
                           d_grad, d_eval, card, time.perf_counter() - t0, worst), flush=True)
            gates.append((f"{model} {feat_type}", d_grad, d_eval, worst))
            record(f"{model} {feat_type}", res, prof, group)
            torch.cuda.empty_cache()

        # (c) top-N: 18 UTT stores named by the top 6 of each rank list;
        # three of them are (a)'s HuBERT, MacBERT and CLIP stores at the
        # same widths, the others the child's
        t0 = time.perf_counter()
        writer.join()
        check(writer.exitcode == 0, f"17 top-N's store writer exited {writer.exitcode}")
        t_wait = time.perf_counter() - t0
        topn = {f: utt.get(feature_dir_name(f, "UTT")) for f in fnames}
        topn.update({f: fusion_features(np.random.default_rng(seed), all_emos, dim)
                     for f, dim, seed in specs})
        ep, nf = epochs["topn"], folds["topn"]
        with mer2023_folds(nf):
            res, secs, prof = zoo_release(torch, [
                "--dataset=MER2023", "--fusion_topn=6", "--fusion_modality=AVT",
                "--model=attention_topn", "--feat_type=utt", "--seed=0", "--batch_size=32",
                f"--epochs={ep}", f"--features_root={fdir}",
                f"--label_path={os.path.join(d, 'label.npz')}",
                f"--save_root={os.path.join(d, 'saved', 'topn')}", "--device", dev], ep * nf)
        got = res.test_results["test3"]["emoprobs"]
        check(got.shape == (splits["test3"], 6) and bool(np.isfinite(got).all()),
              f"17 top-N test3 logits {got.shape}")
        hp = seed0_hp("attention_topn")
        sl = slice(0, small["train"] + small["test1"])
        e = all_emos[sl]
        both = TopNFeatureDataset(names[sl], [topn[f][sl] for f in fnames], e.astype(np.int32),
                                  ((e - 2.5) / 2.5).astype(np.float32))
        cut = small["train"]
        sets = {s: TopNFeatureDataset(both.names[r], [x[r] for x in both.feats],
                                      both.emos[r], both.vals[r])
                for s, r in (("train", slice(0, cut)), ("test1", slice(cut, None)))}
        t0 = time.perf_counter()
        worst = {}
        d_grad, d_eval = zoo_card_vs_cpu(torch, "attention_topn", hp, sets, dev, "utt", worst)
        widths = [topn[f].shape[1] for f in fnames]
        print(zoo_line(f"c: top-N --fusion_topn=6 AVT attention_topn (hidden "
                       f"{hp['hidden_dim']}) on 18 UTT stores {dict(zip(fnames, widths))} "
                       f"({sum(widths)} floats a clip; the {len(specs)} not in (a) written "
                       f"by a child process during (a)-(b), {t_wait:.1f} s waited for it)",
                       res, secs, prof, n_train, ep, nf, d_grad, d_eval, card,
                       time.perf_counter() - t0, worst), flush=True)
        gates.append(("top-N", d_grad, d_eval, worst))
        record("topn", res, prof, "topn")
        del topn

        # (d) the sweep over 12b's attention flags, hyperparameters searched;
        # the last epoch of the last repeat under the profiler
        calls, run_one = [], main_release.main

        def recording(argv):
            calls.append((list(argv), run_one(argv)))
            return calls[-1][1]

        ep, nf = epochs["sweep"], folds["sweep"]
        flags = [f for f in fusion_flags(fdir, os.path.join(d, "label.npz"),
                                         os.path.join(d, "saved", "sweep"),
                                         [f for f, _ in FUSION_FEATURES])
                 if f != "--seed=0"] + ["--batch_size=32", f"--epochs={ep}", "--device", dev]
        main_release.main = recording  # the sweep calls it by name
        try:
            t0 = time.perf_counter()
            n_s, n_r = ZOO_SWEEP["n_search"], ZOO_SWEEP["n_repeat"]
            with mer2023_folds(nf), RunProbe(torch, (n_s + n_r) * ep * nf) as p:
                _, out = quiet(sweep.main, [f"--n_search={n_s}", f"--n_repeat={n_r}", "--",
                                            *flags])
            secs = time.perf_counter() - t0
        finally:
            main_release.main = run_one
        line = json.loads(out.strip().splitlines()[-1])
        scores = [float(r.cv["emofscore"]) for _, r in calls]  # the sweep's key
        best = int(np.argmax(scores[:n_s]))
        hp = calls[best][1].chosen_hp
        carried = all(f"--{k}={v}" in argv for argv, _ in calls[n_s:] for k, v in hp.items())
        check(len(calls) == n_s + n_r and carried, f"17 sweep calls {[a for a, _ in calls]}")
        check(line["n_search"] == n_s and line["n_repeat"] == n_r
              and abs(line["best_search"] - scores[best]) < 1e-12,
              f"17 sweep line {line}")
        durations = [r.duration for _, r in calls]
        wall, busy, _ = p.prof
        fold_s = float(np.mean(np.diff(p.starts)[::nf]))  # each run's first fold
        print(f"[17 zoo] d: cli.sweep --n_search={n_s} --n_repeat={n_r} over 12b's "
              f"attention flags ({ep} epoch(s) x {nf} folds a run, hyperparameters "
              f"searched): search cv WAF {[round(x, 4) for x in scores[:n_s]]}, winner run {best} "
              f"{hp} carried into both repeats; the JSON line {line}; "
              f"first folds {fold_s:.3f} s, "
              f"{fold_steps(n_train, ep, nf) / fold_s:.1f} training steps/s; run_cv "
              f"{np.mean(durations):.1f} s a run; "
              f"{secs:.1f} s for the {n_s + n_r} runs; the last repeat's last epoch under the "
              f"profiler: wall {wall:.1f} ms, busy {busy:.1f} ms, idle share "
              f"{1 - busy / wall:.3f} [{card}]", flush=True)
        results["sweep"] = dict(wall=wall, busy=busy, fold_s=fold_s,
                                steps_s=fold_steps(n_train, ep, nf) / fold_s,
                                waf=line["repeat_mean"])
    print(f"[17 zoo] phase 17 took {time.perf_counter() - t_phase:.1f} s; idle "
          f"shares { {k: round(1 - r['busy'] / r['wall'], 3) for k, r in results.items()} } "
          f"[{card}]", flush=True)
    failed = [(label, g, e, w) for label, g, e, w in gates
              if g > FUSION_TOL or e > FUSION_TOL]
    check(not failed, f"17 card vs CPU over {FUSION_TOL}: {failed}")
    return results


# ------------------------------------------------------------ serving (18)
# TinyLlama-1.1B (phase 10's geometry) with AffectGPT's LoRA r 16 on the
# seven projections, as inference_mllm serves it
SERVE_LLM = dict(vocab_size=32000, hidden_size=2048, num_layers=22, num_heads=32,
                 num_kv_heads=4, intermediate_size=5632, lora_r=16)
# (a) 8 ragged token prompts of 64-448 tokens (one bucket of 448), 64 and
# 128 new tokens for the marginal rate, each timed the fastest of ``reps``
# calls
SERVE_MIX = {"B": 8, "lo": 64, "hi": 448, "new": (64, 128), "reps": 1}
# (b) the engine: 64 token-id requests of 16-448 tokens with budgets of
# 16-128 new tokens, 16 slots, chunks of 32
ENGINE_MIX = {"n": 64, "lo": 16, "hi": 448, "new_lo": 16, "new_hi": 128, "slots": 16,
              "chunk": 32, "buckets": (32, 64, 128, 256, 512)}
# (d) inference_mllm's AffectGPT: phase 10's Q-Formers, CLIP-L FRA (768)
# and HuBERT-large FRA (1024) stores, the CLI's 64-frame caps
SERVE_AFFECT = {"video_dim": 768, "audio_dim": 1024, "frames": 64, "clips": 16,
                "qformer": dict(hidden_size=768, num_layers=2, num_heads=12,
                                intermediate_size=3072)}
# the checks run at full width with this many layers, fp32
CHECK_LAYERS = 2
# depth of the whole script's serving model: 11 of TinyLlama's 22 layers at
# its published width (phase 18 took 103.1 s at 22, PR 18 call 14; NVIDIA
# H100 80GB HBM3, 700 W), a cut that makes room for phase 22
SERVE_DEPTH = 11
# max |a - b| / max |b|: the KV-cached decode against LLM.forward, w8
# against its dequantized weights, int8 KV against full precision (the JAX
# package's ~1e-2 logit class, with headroom), the card against the CPU
SERVE_TOL = {"cached": 1e-3, "w8": 1e-3, "kv_int8": 5e-2, "cpu": 1e-4}


class LLMCharTokenizer:
    """A character-level stand-in for TinyLlama's tokenizer (no tokenizer
    file is in the repository, and the card's machine has no
    ``transformers``): BOS 1, EOS 2, one id a character inside the
    ``vocab``-entry vocabulary; ``decode`` gives each id a CJK character, so
    decoded text is printable and alphabetic. Plain encoding, no chat
    template."""

    bos_token_id, eos_token_id, pad_token_id, chat_template = 1, 2, 0, None

    def __init__(self, vocab: int = 32000):
        self.vocab = vocab

    def encode(self, text: str, add_special_tokens: bool = True) -> list:
        return ([self.bos_token_id] if add_special_tokens else []) + [
            3 + ord(c) % (self.vocab - 3) for c in text]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return "".join(chr(0x4E00 + (int(i) - 3) % 20000) for i in ids
                       if int(i) >= 3 or not skip_special_tokens)


def serving_prompts(rng, n: int, lo: int, hi: int, vocab: int) -> list:
    """``n`` seeded token prompts of ``lo``-``hi`` tokens, the shortest and
    the longest among them, ids in [3, vocab)."""
    lens = ([lo, hi] + rng.integers(lo, hi + 1, n - 2).tolist())[:n]
    return [rng.integers(3, vocab, size=int(n_tok)).tolist() for n_tok in lens]


def engine_requests(rng, mix: dict, vocab: int) -> list:
    """(token ids, max_new_tokens) of ``mix["n"]`` requests: prompts as
    :func:`serving_prompts`, budgets drawn from ``new_lo``-``new_hi``."""
    prompts = serving_prompts(rng, mix["n"], mix["lo"], mix["hi"], vocab)
    news = rng.integers(mix["new_lo"], mix["new_hi"] + 1, len(prompts))
    news[:2] = mix["new_lo"], mix["new_hi"]
    return list(zip(prompts, news.tolist()))


def pad_prompts(torch, prompts: list, S: int, dev):
    """Right-padded (B, S) token ids and mask on ``dev``."""
    ids = np.zeros((len(prompts), S), np.int64)
    mask = np.zeros((len(prompts), S), np.int64)
    for b, p in enumerate(prompts):
        ids[b, : len(p)], mask[b, : len(p)] = p, 1
    return torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)


def marginal_rate(times: dict, B: int) -> tuple[float, float]:
    """(ms a decode step, tokens/s) from the wall ms of two ``generate``
    calls that differ only in ``max_new_tokens`` ({new tokens: ms}). Fails
    unless the longer call took longer (bench.py's marginal rate has no
    such guard)."""
    (n0, t0), (n1, t1) = sorted(times.items())
    check(t1 - t0 > 0, f"marginal decode rate: {n1} new tokens took {t1:.1f} ms, "
                       f"{n0} took {t0:.1f} ms")
    step = (t1 - t0) / (n1 - n0)
    return step, B * 1e3 / step


def decode_step_bound(model, B: int, kv_tokens: int, kv_int8: bool) -> tuple[float, str, float]:
    """(bound ms, "bytes" or "operations", bytes) of one decode step of
    ``B`` rows: every weight read once (the embedding table only for its B
    rows) and ``kv_tokens`` cached K and V entries summed over the rows,
    each read once; the operations are 2 a weight a row plus both
    attention products."""
    cfg = model.cfg
    hd = cfg.hidden_size // cfg.num_heads
    table = model.embed_tokens.weight
    w_bytes = sum(t.numel() * t.element_size()
                  for t in [*model.parameters(), *model.buffers()] if t is not table)
    w_bytes += B * cfg.hidden_size * table.element_size()
    per_entry = hd + 4 if kv_int8 else hd * 2          # int8 codes + fp32 scale, or bf16
    kv_bytes = 2 * cfg.num_layers * cfg.num_kv_heads * kv_tokens * per_entry
    n_w = sum(t.numel() for t in [*model.parameters(), *model.buffers()]
              if t is not table and t.dim() == 2)
    flops = 2.0 * B * n_w + 4.0 * cfg.num_layers * cfg.num_heads * hd * kv_tokens
    return (*bound(w_bytes + kv_bytes, flops, "bf16"), w_bytes + kv_bytes)


def no_launches(wrappers, label: str) -> dict:
    """The kernels' counts; fails if any of them launched."""
    counts = {w.__name__: w.launches for w in wrappers}
    check(not any(counts.values()), f"{label} launched {counts}")
    return counts


def wall_ms(torch, fn, dev):
    """(wall ms of ``fn()`` with the device drained before and after, its
    result)."""
    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return (time.perf_counter() - t0) * 1e3, out


def serving_llm(torch, tl, cfg, dev, seed: int):
    """The port's LLM at ``cfg`` on ``dev``, drawn by ``llm.init_weights``
    from ``seed``, with the LoRA B matrices drawn too (normal 0.02) so the
    LoRA deltas take part."""
    model = tl.LLM(cfg, device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    tl.init_weights(model, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_B"):
                p.normal_(0.0, 0.02, generator=gen)
    return model.eval()


def write_hf_llm(torch, d: str, model) -> str:
    """A local HF-layout causal-LM directory of ``model`` (the LoRA deltas
    left out): a Llama ``config.json`` and a bf16 ``pytorch_model.bin``
    with the keys under ``model.``."""
    cfg = model.cfg
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": cfg.vocab_size,
                   "hidden_size": cfg.hidden_size, "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads,
                   "intermediate_size": cfg.intermediate_size,
                   "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta}, f)
    sd = {(k if k.startswith("lm_head") else f"model.{k}"): v.detach().to("cpu", torch.bfloat16)
          for k, v in model.state_dict().items() if "lora_" not in k}
    torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    return d


@contextlib.contextmanager
def stand_in_tokenizer(tok):
    """``core.checkpoint.load_tokenizer`` returns ``tok`` (e.g.
    :class:`LLMCharTokenizer`) inside the block (phase 13b's way round the
    missing tokenizer files)."""
    from mertools_tpu_torch.core import checkpoint

    load = checkpoint.load_tokenizer
    checkpoint.load_tokenizer = lambda path: tok
    try:
        yield
    finally:
        checkpoint.load_tokenizer = load


def serving_engine(torch, model, requests, mix: dict, dev, dtype=None, P: int = 0, **kw):
    """(each request's tokens, the engine) of ``ContinuousBatcher`` over
    ``requests`` submitted as token ids; ``P`` is the length of a shared
    prefix passed in ``kw``."""
    from mertools_tpu_torch.mllm.serve import ContinuousBatcher

    eng = ContinuousBatcher(model, n_slots=mix["slots"],
                            max_len=P + mix["buckets"][-1] + mix["new_hi"],
                            max_new_tokens=mix["new_hi"], prefill_buckets=mix["buckets"],
                            chunk=mix["chunk"], compute_dtype=dtype, device=dev, **kw)
    rids = [eng.submit(prompt_ids=ids, max_new_tokens=n) for ids, n in requests]
    out = eng.run()
    return [out[r] for r in rids], eng


def phase_serving(torch, card, dev: str = "cuda", llm=SERVE_LLM, mix=SERVE_MIX,
                  engine=ENGINE_MIX, affect=SERVE_AFFECT) -> dict:
    """18: AffectGPT generation and serving on the port's LLM at ``llm``'s
    geometry with seeded weights: (a) ``generate``, bf16 greedy, on
    ``mix``'s ragged prompts: prefill ms, a decode step's ms and tokens/s
    from the marginal rate of two lengths (guarded), peak memory, the idle
    share of one decode step and its bytes bound, then w8, int8 KV and both;
    at full width and 2 layers in fp32 the cached decode against
    ``LLM.forward``, w8 against its dequantized weights, int8 KV against
    full precision, and the card against the CPU; (b) ``ContinuousBatcher``
    on ``engine``'s requests, bf16 at full depth: requests/s, tokens/s and
    a chunk's idle share; at 2 layers fp32 each request against
    ``generate`` on its prompt alone, with and without a 32-token shared
    prefix; (c) ``beam_generate`` (4 beams, B 2, 32 tokens) on the card
    against the CPU; (d) ``inference_mllm`` on CLIP-L/HuBERT FRA stores
    from a ``save_model`` AffectGPT (2 LLM layers) on the card against the
    CPU, ``ovlabel_extraction --engine=continuous --w8 --bf16`` and
    ``translate`` on a written HF-layout directory. Returns the rates."""
    from mertools_tpu_torch.cli import inference_mllm, ovlabel_extraction, translate
    from mertools_tpu_torch.mllm import affectgpt as ta
    from mertools_tpu_torch.mllm import beam as tb
    from mertools_tpu_torch.mllm import generate as tg
    from mertools_tpu_torch.mllm import llm as tl
    from mertools_tpu_torch.mllm import qformer as tq
    from mertools_tpu_torch.mllm import runner as tr

    t_phase = time.perf_counter()
    cuda = torch.device(dev).type == "cuda"
    cfg = tl.LLMConfig(**llm)
    V = cfg.vocab_size
    rng = np.random.default_rng(18)

    # (a) generate at full depth: bf16, and w8 quantized from the fp32 draw
    t0 = time.perf_counter()
    full = serving_llm(torch, tl, cfg, dev, 18)
    bf = tg.cast_llm_bf16(copy.deepcopy(full))
    w8 = tg.cast_llm_bf16(tg.quantize_llm_w8(full))   # in place: the fp32 copy goes
    del full
    n_params = sum(p.numel() for p in bf.parameters())
    print(f"[18 serving] a: LLM hidden {cfg.hidden_size}, {cfg.num_layers} layers, "
          f"{cfg.num_heads} heads, {cfg.num_kv_heads} KV heads, FFN "
          f"{cfg.intermediate_size}, vocab {V}, LoRA r {cfg.lora_r}: "
          f"{n_params / 1e6:.1f} M params, bf16 and w8 (+ bf16) copies built in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    prompts = serving_prompts(rng, mix["B"], mix["lo"], mix["hi"], V)
    B, S = len(prompts), tg.bucket_len(max(map(len, prompts)))
    ids, mask = pad_prompts(torch, prompts, S, dev)
    n_short, n_long = mix["new"]

    def gen(model, n, kv_int8=False):
        emb = model.embed_tokens.weight[ids].float() * mask[..., None]
        return tg.generate(model, emb, mask, max_new_tokens=n, eos_token_id=-1,
                           kv_int8=kv_int8)

    emb_bf = bf.embed_tokens.weight[ids].float() * mask[..., None]
    gen(bf, 4)   # warm-up: cuBLAS handles and the allocator's blocks
    pre_ms = float(np.median([wall_ms(torch, lambda: tg.prefill(bf, emb_bf, mask, S + n_long),
                                      dev)[0] for _ in range(3)]))
    n_kv = int(mask.sum()) + B * n_long // 2            # a step halfway through
    rates = {}
    for label, model, kv in (("bf16", bf, False), ("w8", w8, False),
                             ("kv_int8", bf, True), ("w8+kv_int8", w8, True)):
        gen(model, 4, kv)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        times = {n: min(wall_ms(torch, lambda: gen(model, n, kv), dev)[0]
                        for _ in range(mix["reps"])) for n in (n_short, n_long)}
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
        step_ms, tok_s = marginal_rate(times, B)
        b_ms, b_by, b_bytes = decode_step_bound(model, B, n_kv, kv)
        rates[label] = {"step_ms": step_ms, "tok_s": tok_s, "bound_ms": b_ms}
        print(f"[18 serving] a: generate {label}, B {B} prompts of {mix['lo']}-{mix['hi']} "
              f"tokens (bucket {S}), greedy: {n_short} new tokens {times[n_short]:.1f} ms, "
              f"{n_long} {times[n_long]:.1f} ms; marginal {step_ms:.3f} ms a step, "
              f"{tok_s:.1f} tokens/s ({B * n_long * 1e3 / times[n_long]:.1f} over the whole "
              f"{n_long}-token call); peak memory {peak:.2f} GiB; a step's bound "
              f"{b_ms:.4f} ms by {b_by} ({b_bytes / 1e9:.3f} GB: weights + {n_kv} cached "
              f"tokens' K and V, {HBM_BPS / 1e12:.2f} TB/s), {b_ms / step_ms:.1%} of it "
              f"[{card}]", flush=True)
    print(f"[18 serving] a: prefill of the {B} x {S} bucket (bf16, median of 3): "
          f"{pre_ms:.1f} ms [{card}]", flush=True)
    if cuda:   # one decode step under the profiler, halfway into a 128-token run
        logits, kc, vc, n_valid = tg.prefill(bf, emb_bf, mask, S + n_long)
        slot_mask = torch.zeros(B, S + n_long, dtype=torch.bool, device=dev)
        slot_mask[:, :S] = mask.bool()
        slot_mask[:, S] = True
        tok = logits.argmax(-1)
        with torch.inference_mode():
            wall, busy, top, left, with_ranges = device_profile(
                torch, lambda: tg._step(bf, tok, n_valid, S, kc, vc, slot_mask))
        print(f"[18 serving] a: profile of one bf16 decode step ({wall:.2f} ms under "
              f"the profiler): {profile_line(busy, top, left, with_ranges, wall)} [{card}]",
              flush=True)
        del kc, vc
    del w8

    # the checks: full width, CHECK_LAYERS layers, fp32
    small = serving_llm(torch, tl, dataclasses.replace(cfg, num_layers=CHECK_LAYERS), dev, 19)
    cpu = copy.deepcopy(small).cpu()
    cp = serving_prompts(np.random.default_rng(19), 3, 16, min(160, mix["hi"]), V)
    cS = tg.bucket_len(max(map(len, cp)))
    cids, cmask = pad_prompts(torch, cp, cS, dev)
    cemb = small.embed_tokens.weight[cids].detach() * cmask[..., None]
    toks = tg.generate(small, cemb, cmask, max_new_tokens=16, eos_token_id=-1)
    cached = tg.decode_logits(small, cemb, cmask, toks)
    d_cached = rel_err(torch, cached, tg.teacher_forced_logits(small, cemb, cmask, toks))
    d_kv8 = rel_err(torch, tg.decode_logits(small, cemb, cmask, toks, kv_int8=True), cached)
    w8s = tg.quantize_llm_w8(copy.deepcopy(small))
    deq = copy.deepcopy(small)
    with torch.no_grad():
        for name, mod in w8s.named_modules():
            if isinstance(mod, tg.W8Linear):
                deq.get_submodule(name).weight.copy_(mod.dequantized())
    d_w8 = rel_err(torch, tg.prefill(w8s, cemb, cmask, cS)[0], tg.prefill(deq, cemb, cmask, cS)[0])
    del w8s, deq
    d_cpu = rel_err(torch, tg.prefill(small, cemb, cmask, cS)[0].cpu(),
                        tg.prefill(cpu, cemb.cpu(), cmask.cpu(), cS)[0])
    toks_cpu = tg.generate(cpu, cemb.cpu(), cmask.cpu(), max_new_tokens=16, eos_token_id=-1)
    same_greedy = bool(torch.equal(toks.cpu(), toks_cpu))
    print(f"[18 serving] a: checks at full width, {CHECK_LAYERS} layers, fp32, {len(cp)} "
          f"prompts of 16-{max(map(len, cp))} tokens, 16 new: KV-cached decode against "
          f"LLM.forward teacher-forced {d_cached:.3e} (limit {SERVE_TOL['cached']}); w8 "
          f"against its dequantized weights {d_w8:.3e} (limit {SERVE_TOL['w8']}); int8 KV "
          f"against full precision {d_kv8:.3e} of max logit (limit {SERVE_TOL['kv_int8']}); "
          f"card against CPU: prefill logits {d_cpu:.3e} (limit {SERVE_TOL['cpu']}), greedy "
          f"tokens {'equal' if same_greedy else 'DIFFER'} [{card}]", flush=True)
    check(d_cached <= SERVE_TOL["cached"], f"18a cached decode vs forward {d_cached}")
    check(d_w8 <= SERVE_TOL["w8"], f"18a w8 vs dequantized {d_w8}")
    check(d_kv8 <= SERVE_TOL["kv_int8"], f"18a int8 KV vs full precision {d_kv8}")
    check(d_cpu <= SERVE_TOL["cpu"], f"18a card vs CPU prefill logits {d_cpu}")
    check(same_greedy, "18a card vs CPU greedy tokens differ")

    # (b) the engine, bf16 at full depth
    reqs = engine_requests(rng, engine, V)
    serving_engine(torch, bf, reqs[:2], engine, dev, "bf16", eos_token_id=2)   # warm-up
    ms, (outs, _) = wall_ms(torch, lambda: serving_engine(torch, bf, reqs, engine, dev, "bf16",
                                                          eos_token_id=2), dev)
    check(all(1 <= len(o) <= n for o, (_, n) in zip(outs, reqs)), "18b a request's length")
    n_tok = sum(map(len, outs))
    rates["engine"] = {"req_s": len(reqs) * 1e3 / ms, "tok_s": n_tok * 1e3 / ms}
    print(f"[18 serving] b: ContinuousBatcher bf16, {len(reqs)} token-id requests of "
          f"{engine['lo']}-{engine['hi']} tokens, budgets {engine['new_lo']}-"
          f"{engine['new_hi']}, {engine['slots']} slots, chunk {engine['chunk']}, EOS 2: "
          f"{ms / 1e3:.2f} s, {rates['engine']['req_s']:.2f} requests/s, "
          f"{rates['engine']['tok_s']:.1f} tokens/s ({n_tok} tokens) [{card}]", flush=True)
    if cuda:   # one chunk of a full engine under the profiler
        from mertools_tpu_torch.mllm.serve import ContinuousBatcher

        eng = ContinuousBatcher(bf, n_slots=engine["slots"],
                                max_len=engine["buckets"][-1] + engine["new_hi"],
                                eos_token_id=-1, max_new_tokens=engine["new_hi"],
                                prefill_buckets=engine["buckets"], chunk=engine["chunk"],
                                compute_dtype="bf16", device=dev)
        for p, _ in reqs[: engine["slots"]]:
            eng.submit(prompt_ids=p)
        eng.step()   # admission and the first chunk
        wall, busy, top, left, with_ranges = device_profile(torch, eng.step)
        print(f"[18 serving] b: profile of one chunk ({engine['chunk']} steps x "
              f"{engine['slots']} slots, {wall:.1f} ms under the profiler): "
              f"{profile_line(busy, top, left, with_ranges, wall)} [{card}]", flush=True)
        del eng
    del bf
    if cuda:
        torch.cuda.empty_cache()

    small_mix = {**engine, "slots": 4, "chunk": 8, "new_lo": 4, "new_hi": 24,
                 "buckets": (32, 64, 128, 256), "n": 12, "hi": min(200, engine["hi"])}
    creqs = engine_requests(np.random.default_rng(20), small_mix, V)
    pre = np.random.default_rng(21).integers(3, V, 32).tolist()
    table = small.embed_tokens.weight.detach()
    bad = []
    for P in (0, 32):
        kw = {}
        if P:
            kw = dict(prefix=tg.prefill_prefix(small, table[torch.as_tensor(pre, device=dev)]),
                      prefix_token_ids=pre, P=P)
        got, _ = serving_engine(torch, small, creqs, small_mix, dev, eos_token_id=-1, **kw)
        for (ids_r, n), toks_r in zip(creqs, got):
            full_ids = torch.as_tensor(pre[:P] + ids_r, device=dev)
            alone = tg.generate(small, table[full_ids][None], torch.ones_like(full_ids)[None],
                                max_new_tokens=n, eos_token_id=-1)[0].tolist()
            if toks_r != alone:
                bad.append((P, len(ids_r), n))
    print(f"[18 serving] b: at {CHECK_LAYERS} layers fp32, {len(creqs)} requests of "
          f"16-{small_mix['hi']} tokens, budgets 4-24, 4 slots, chunk 8: each request's "
          f"tokens against generate on its prompt alone, without and with a 32-token "
          f"shared prefix: {len(bad)} of {2 * len(creqs)} differ {bad[:4]} [{card}]",
          flush=True)
    check(not bad, f"18b engine vs generate differ on {bad}")

    # (c) beam search, card against CPU
    bp = serving_prompts(np.random.default_rng(22), 2, 40, min(70, mix["hi"]), V)
    bS = max(map(len, bp))
    bids, bmask = pad_prompts(torch, bp, bS, dev)
    bemb = table[bids] * bmask[..., None]
    t0 = time.perf_counter()
    beams = tb.beam_generate(small, bemb, bmask, num_beams=4, max_new_tokens=32,
                             eos_token_id=2)
    b_s = time.perf_counter() - t0
    beams_cpu = tb.beam_generate(cpu, bemb.cpu(), bmask.cpu(), num_beams=4,
                                 max_new_tokens=32, eos_token_id=2)
    print(f"[18 serving] c: beam_generate 4 beams, B 2 ({[len(p) for p in bp]} tokens), "
          f"32 new, fp32 at {CHECK_LAYERS} layers: {b_s:.2f} s on the card; beams "
          f"{'equal' if beams == beams_cpu else 'DIFFER'} to the CPU's (lengths "
          f"{[len(b) for b in beams]}) [{card}]", flush=True)
    check(beams == beams_cpu, f"18c beams differ: {beams} vs {beams_cpu}")

    # (d) the CLIs
    with tempfile.TemporaryDirectory() as d, stand_in_tokenizer(LLMCharTokenizer(V)):
        qf = affect["qformer"]
        acfg = ta.AffectGPTConfig(
            llm=small.cfg, video_qformer=tq.QFormerConfig(num_queries=32, **qf),
            audio_qformer=tq.QFormerConfig(num_queries=8, **qf),
            video_dim=affect["video_dim"], audio_dim=affect["audio_dim"],
            max_video_frames=affect["frames"], max_audio_frames=affect["frames"])
        amodel = ta.build(acfg, dev, seed=23)
        with torch.no_grad():
            amodel.llm.load_state_dict(small.state_dict())
        ckpt = tr.save_model(os.path.join(d, "model"), amodel)
        del amodel
        crng = np.random.default_rng(24)
        names = [f"clip_{i:03d}" for i in range(affect["clips"])]
        for sub, dim, lo, hi in (("v", affect["video_dim"], 20, 120),
                                 ("a", affect["audio_dim"], 100, 500)):
            os.makedirs(os.path.join(d, sub))
            for n in names:
                np.save(os.path.join(d, sub, f"{n}.npy"),
                        crng.normal(size=(crng.integers(lo, hi), dim)).astype(np.float32))
        with open(os.path.join(d, "sub.csv"), "w", encoding="utf-8") as f:
            f.write("name,sentence\n" + "".join(
                f"{n},{CharTokenizer.sentence(crng, int(crng.integers(8, 40)))}\n" for n in names))
        argv = [f"--ckpt={ckpt}", "--tokenizer=stand-in",
                f"--video_feat_dir={os.path.join(d, 'v')}",
                f"--audio_feat_dir={os.path.join(d, 'a')}",
                f"--subtitle_csv={os.path.join(d, 'sub.csv')}", "--batch=8",
                "--max_new_tokens=16", f"--max_video_frames={affect['frames']}",
                f"--max_audio_frames={affect['frames']}"]
        got = {}
        for leg in (dev, "cpu"):
            t0 = time.perf_counter()
            out = os.path.join(d, f"name2reason_{leg}.npz")
            quiet(inference_mllm.main, argv + [f"--save_path={out}", "--device", leg])
            got[leg] = (np.load(out, allow_pickle=True)["name2reason"].item(),
                        time.perf_counter() - t0)
        same = got[dev][0] == got["cpu"][0]
        print(f"[18 serving] d: inference_mllm on {len(names)} clips of CLIP-L FRA "
              f"({affect['video_dim']}) and HuBERT FRA ({affect['audio_dim']}) stores, "
              f"AffectGPT (LLM {CHECK_LAYERS} layers at full width, fp32) from "
              f"runner.save_model: {got[dev][1]:.1f} s on the card, {got['cpu'][1]:.1f} s on "
              f"the CPU; name2reason texts {'equal' if same else 'DIFFER'} [{card}]",
              flush=True)
        check(sorted(got[dev][0]) == names and same, "18d inference_mllm card vs CPU")

        hf = write_hf_llm(torch, os.path.join(d, "hf"), small)
        reasons = {n: CharTokenizer.sentence(crng, int(crng.integers(20, 80))) for n in names[:8]}
        np.savez_compressed(os.path.join(d, "reasons.npz"),
                            name2reason=np.array(reasons, dtype=object))
        t0 = time.perf_counter()
        quiet(ovlabel_extraction.main, [
            f"--reason_npz={os.path.join(d, 'reasons.npz')}", f"--model={hf}",
            f"--store_npz={os.path.join(d, 'openset.npz')}", "--engine=continuous",
            "--w8", "--bf16", "--batch=4", "--max_new_tokens=16", "--device", dev])
        t_ov = time.perf_counter() - t0
        ov = np.load(os.path.join(d, "openset.npz"), allow_pickle=True)
        labels = dict(zip(map(str, ov["filenames"]), map(str, ov["fileitems"])))
        with open(os.path.join(d, "trans.csv"), "w", encoding="utf-8") as f:
            f.write("name,chinese\n" + "".join(f"{n},{s}\n" for n, s in reasons.items())
                    + "empty,\n")
        t0 = time.perf_counter()
        quiet(translate.main, [f"--trans_path={os.path.join(d, 'trans.csv')}",
                               f"--save_path={os.path.join(d, 'eng.csv')}", f"--model={hf}",
                               "--batch=4", "--max_new_tokens=16", "--device", dev])
        t_tr = time.perf_counter() - t0
        with open(os.path.join(d, "eng.csv"), newline="", encoding="utf-8") as f:
            eng_rows = {r["name"]: r["english"] for r in csv.DictReader(f)}
    print(f"[18 serving] d: ovlabel_extraction --engine=continuous --w8 --bf16 on "
          f"{len(labels)} reasons ({t_ov:.1f} s), {sum(map(bool, labels.values()))} "
          f"non-empty label sets; translate on {len(eng_rows)} rows ({t_tr:.1f} s), "
          f"{sum(map(bool, eng_rows.values()))} non-empty; both from a written HF-layout "
          f"directory ({CHECK_LAYERS} layers at full width) [{card}]", flush=True)
    check(sorted(labels) == sorted(reasons) and any(labels.values()),
          f"18d ovlabel_extraction wrote {labels}")
    check(all(eng_rows[n] for n in reasons) and eng_rows["empty"] == "",
          f"18d translate wrote {eng_rows}")
    print(f"[18 serving] phase 18 took {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return rates


def serving_phase(torch, wrappers, card) -> dict:
    """Phase 18 with the kernels' counts set to 0 before it and read after
    it: the JAX serving path reaches no Pallas kernel, so neither does the
    port's."""
    for w in wrappers:
        w.launches = 0
    rates = phase_serving(torch, card, llm={**SERVE_LLM, "num_layers": SERVE_DEPTH})
    counts = no_launches(wrappers, "phase 18")
    print(f"[18 serving] kernel launches in phase 18: {counts} [{card}]", flush=True)
    return rates


@contextlib.contextmanager
def stores_read_once():
    """While active, ``feature_store.read_features`` reads each (root,
    names) from disk once and hands later calls the same arrays (no caller
    writes to them). Phase 17's ``main_release`` runs share their stores,
    and ``np.load`` costs ~0.5 ms a file on the card machine's host, 13-26
    s a run; the first run of each store kind still reads them."""
    from mertools_tpu_torch.data import feature_store

    read, memo = feature_store.read_features, {}

    def read_once(root, names, *args, **kw):
        key = (root, tuple(names))
        if key not in memo:
            memo[key] = read(root, names, *args, **kw)
        return memo[key]

    feature_store.read_features = read_once
    try:
        yield memo
    finally:
        feature_store.read_features = read


def zoo_phase(torch, wrappers, card) -> None:
    """Phase 17 with the kernels' counts set to 0 before it and read after
    it: no zoo model launches B1, B2 or B3. Each store is read from disk
    once (:func:`stores_read_once`)."""
    for w in wrappers:
        w.launches = 0
    with stores_read_once():
        phase_fusion_zoo(torch, card)
    zoo_launches = {w.__name__: w.launches for w in wrappers}
    print(f"[17 zoo] kernel launches in phase 17: {zoo_launches} [{card}]", flush=True)
    check(not any(zoo_launches.values()), f"phase 17 launched {zoo_launches}")


# ------------------------------------------------ e2e fine-tuning (phase 19)
# (a): HuBERT-large at published width; the folds and epochs are cuts of
# MER2023's 5 x 100, the clip count is the phase's own
E2E_AUDIO = {"clips": 256, "lo_s": 2.0, "hi_s": 6.0, "nseg": 8, "seglen": 32000,
             "batch": 32, "fallback_batch": 16, "folds": 2, "epochs": 2}
# the card-vs-CPU legs: depth cut to these layers, rows to these counts
E2E_CHECK = {"audio_layers": 2, "text_layers": 3, "vision_layers": 2, "clips": 8,
             "nseg": 2, "batch": 4}
# (c): one fold x one epoch of MacBERT-large (3 layers) and CLIP-L (2 layers)
E2E_TEXT_VISION = {"text_clips": 64, "video_clips": 24, "batch": 8}
E2E_TOL = 1e-4        # card vs CPU: each gradient (ZOO_GRAD_FLOOR), logits
# depth of the whole script's phase 19 HuBERT-large (a, b, d): 12 of its 24
# layers at published width (phase 19 took 93.4 s at 24, PR 18 call 14;
# NVIDIA H100 80GB HBM3, 700 W), a cut that makes room for phase 22
E2E_LAYERS = 12
FINETUNED_TOL = 1e-5  # extract_audio --finetuned_ckpt vs the saved encoder, UTT
INT8_RATIO = 3.0      # int8 vs fp32 at most this times bf16 vs fp32, on UTT


def e2e_step_flop(cfg, segments: int, seg_len: int) -> float:
    """Operations of one e2e training step on a wav2vec2-family backbone,
    counted from the shapes: the conv frontend, the feature projection, the
    positional conv and the transformer layers (their products, attention
    scores and weighted values) forward for ``segments`` windows of
    ``seg_len`` samples, times 3 for the backward. The head is left out
    (under 0.01%)."""
    flop, L, c_in = 0.0, seg_len, 1
    for dim, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        L = (L - k) // s + 1
        flop += 2.0 * L * dim * c_in * k
        c_in = dim
    T, H, F = L, cfg.hidden_size, cfg.intermediate_size
    flop += 2.0 * T * c_in * H
    flop += 2.0 * T * H * (H // cfg.num_conv_pos_embedding_groups) * cfg.num_conv_pos_embeddings
    flop += cfg.num_hidden_layers * (2.0 * T * (4 * H * H + 2 * H * F) + 4.0 * T * T * H)
    return 3.0 * segments * flop


def tone_corpus(rng, n: int, lo_s: float, hi_s: float) -> tuple[dict, dict]:
    """``n`` seeded clips of ``lo_s``-``hi_s`` s in two tone classes, the
    corpus of tests/test_e2e_model.py (200 Hz "neutral", 500 Hz "angry",
    amplitude 0.4) with a random phase and a little noise: (name -> PCM16
    wav, name -> label)."""
    from mertools_tpu_torch.core.globals_mer import EMOS_MER

    wavs, corpus = {}, {}
    for i, secs in enumerate(rng.uniform(lo_s, hi_s, n)):
        e = i % 2
        t = np.arange(int(secs * SR)) / SR
        w = (0.4 * np.sin(2 * np.pi * (200.0, 500.0)[e] * t + rng.uniform(0, 2 * np.pi))
             + 0.02 * rng.normal(size=len(t)))
        name = f"tone{i:03d}"
        wavs[name] = np.clip(np.round(w * 32767.0), -32768, 32767).astype(np.int16)
        corpus[name] = {"emo": EMOS_MER[e], "val": 0.0}
    return wavs, corpus


def write_seeded_checkpoint(root: str, name: str, cfg, sd: dict) -> str:
    """``{root}/{name}``: ``cfg``'s ``config.json`` and the seeded weights
    ``sd`` as ``pytorch_model.bin``, the layout ``--pretrain_dir`` names
    and ``--savemodel`` writes."""
    from mertools_tpu_torch.core.checkpoint import write_hf_checkpoint

    return write_hf_checkpoint(os.path.join(root, name), cfg.to_config_json(), sd)


def int8_gate(d: dict, label: str) -> float:
    """Phase 19d's gate on UTT (the worst clip's max|a - b| / max|b|): int8
    against fp32 at most ``INT8_RATIO`` times bf16 against fp32. Returns
    the ratio."""
    check(d["int8"] <= INT8_RATIO * d["bf16"],
          f"{label} UTT int8 vs fp32 {d['int8']:.3e} > {INT8_RATIO} x bf16 vs "
          f"fp32 {d['bf16']:.3e}")
    return d["int8"] / d["bf16"]


class TrainProbe:
    """While active, ``loop.train_epoch`` runs as it does, but each call is
    timed with the device drained before and after, its batches counted and
    its losses kept, and the ``n``-th call runs under
    :func:`device_profile` on a card (``prof``)."""

    def __init__(self, torch, n: int):
        self.torch, self.n, self.prof = torch, n, None
        self.secs, self.steps, self.losses = [], [], []

    def __enter__(self):
        from mertools_tpu_torch.train import loop

        self.loop, self.orig = loop, loop.train_epoch

        def train_epoch(model, opt, data, idx, *args):
            cuda = idx.is_cuda
            sync = self.torch.cuda.synchronize if cuda else (lambda: None)
            out = []
            sync()
            t0 = time.perf_counter()
            if cuda and len(self.secs) + 1 == self.n:
                self.prof = device_profile(self.torch, lambda: out.append(
                    self.orig(model, opt, data, idx, *args)))
            else:
                out.append(self.orig(model, opt, data, idx, *args))
                sync()
            self.secs.append(time.perf_counter() - t0)
            self.steps.append(int(idx.shape[0]))
            self.losses.append(out[0][0].cpu().numpy())
            return out[0]

        loop.train_epoch = train_epoch
        return self

    def __exit__(self, *exc):
        self.loop.train_epoch = self.orig


def e2e_check(torch, args, sets: dict, backbone_sd: dict, dev: str, batch: int) -> dict:
    """:func:`same_weights_check` for an e2e model: every dropout off and
    ``backbone_sd`` loaded into both copies; each gradient at the
    ``ZOO_GRAD_FLOOR``. Returns (gradient, logits) ratios and the worst
    gradient."""
    from mertools_tpu_torch.models.modules import Dropout

    def prepare(m):
        for mod in m.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
        m.backbone.load_state_dict(backbone_sd)

    worst = {}
    d_grad, d_eval = same_weights_check(torch, args, sets, dev, np.random.default_rng(0),
                                        epochs=1, prepare=prepare, floor=ZOO_GRAD_FLOOR,
                                        worst=worst, batch_size=batch)
    return dict(grad=d_grad, eval=d_eval, worst=worst)


def check_line(r: dict) -> str:
    w = r["worst"]
    return (f"a step's gradients {r['grad']:.3e} (worst {w['tensor']}, its max "
            f"{w['share']:.1e} of the largest, floor {ZOO_GRAD_FLOOR}), a trained "
            f"model's test logits and valence {r['eval']:.3e} (limit {E2E_TOL})")


def e2e_args(**kw):
    from mertools_tpu_torch.core.config import Args

    return Args(model="e2e_model", hidden_dim=256, dropout=0.0, lr=1e-3, l2=1e-5,
                grad_clip=-1.0, output_dim1=6, output_dim2=1, metric_name="emoval",
                feat_type="utt", **kw)


def phase_e2e_audio(torch, card, d: str, dev: str, cfg, sizes: dict) -> dict:
    """19a: ``main_release --model=e2e_model`` on HuBERT-large (``cfg``)
    from a seeded checkpoint under ``{d}/pretrain``, ``--savemodel``; then
    the card against the CPU from the same weights at 2 layers. Returns
    what 19b and 19d reuse."""
    from mertools_tpu_torch.cli import main_release
    from mertools_tpu_torch.data import labels
    from mertools_tpu_torch.data.e2e_dataset import E2EDataset
    from mertools_tpu_torch.encoders import wav2vec2 as tw

    name = "chinese-hubert-large"
    t0 = time.perf_counter()
    sd = tw.init_params(cfg, torch.Generator().manual_seed(19))
    pretrain = os.path.join(d, "pretrain")
    write_seeded_checkpoint(pretrain, name, cfg, sd)
    t_init = time.perf_counter() - t0
    wavs, corpus = tone_corpus(np.random.default_rng(19), sizes["clips"], sizes["lo_s"],
                               sizes["hi_s"])
    audio = os.path.join(d, "audio")
    write_wavs(audio, wavs)
    labels.write_label_archive(os.path.join(d, "label.npz"), {"train": corpus})
    n_calls = sizes["folds"] * sizes["epochs"]
    peak, cut, secs = None, None, None
    for batch in (sizes["batch"], sizes["fallback_batch"]):
        save = os.path.join(d, f"saved_b{batch}")
        flags = ["--dataset=MER2025", "--model=e2e_model", f"--e2e_name={name}",
                 f"--e2e_nseg={sizes['nseg']}", f"--e2e_seglen={sizes['seglen']}",
                 f"--batch_size={batch}", "--savemodel", f"--pretrain_dir={pretrain}",
                 f"--raw_audio_root={audio}", f"--features_root={d}",
                 f"--label_path={os.path.join(d, 'label.npz')}", f"--save_root={save}",
                 f"--epochs={sizes['epochs']}", "--seed=0", "--hidden_dim=256",
                 "--dropout=0.3", "--lr=1e-5", "--device", dev]
        if dev == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            with mer2023_folds(sizes["folds"], "MER2025Loader"), \
                    TrainProbe(torch, n_calls) as probe:
                res, _ = quiet(main_release.main, flags)
            secs = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as exc:
            cut = f"batch {batch} ran out of device memory ({str(exc)[:160]})"
            print(f"[19 e2e] a: {cut}; running batch {sizes['fallback_batch']} "
                  f"[{card}]", flush=True)
            continue
        if dev == "cuda":
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
        break
    else:
        raise RuntimeError("19a: no batch size fit")
    seg_per_batch = batch * sizes["nseg"]
    calls = list(zip(probe.secs, probe.steps))
    # the first epoch warms cuBLAS and cuDNN; the last one ran under the profiler
    steady = [c for i, c in enumerate(calls) if 0 < i < probe.n - 1] or calls
    step_s = sum(s for s, _ in steady) / sum(n for _, n in steady)
    flop = e2e_step_flop(cfg, seg_per_batch, sizes["seglen"])
    prof = ""
    if probe.prof is not None:
        wall, *p = probe.prof
        prof = (f"; the last training epoch ({probe.steps[-1]} steps) under the "
                f"profiler: wall {wall:.1f} ms, {profile_line(*p, wall)}")
    print(f"[19 e2e] a: main_release MER2025 e2e_model {name} (hidden "
          f"{cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
          f"{cfg.num_attention_heads} heads; seeded weights, written and read as "
          f"config.json + pytorch_model.bin, {t_init:.1f} s) on {sizes['clips']} "
          f"tone clips of {sizes['lo_s']:g}-{sizes['hi_s']:g} s, {sizes['nseg']} x "
          f"{sizes['seglen']} samples a clip, batch {batch} ({seg_per_batch} segments "
          f"a step), {sizes['folds']} folds x {sizes['epochs']} epochs, --savemodel: "
          f"{secs:.1f} s; {step_s:.3f} s a training step, "
          f"{seg_per_batch / step_s:.1f} segments/s, {flop / 1e12:.2f} TFLOP a step "
          f"(counted from the shapes) at {flop / step_s / 1e12:.1f} TFLOP/s, "
          f"{flop / step_s / PEAK['fp32']:.3f} of the fp32 peak (steady epochs, "
          f"{sum(probe.steps)} steps in all; training epochs took "
          f"{', '.join(f'{s:.2f}' for s in probe.secs)} s); peak device memory "
          f"{peak if peak is None else round(peak, 2)} GiB; cv "
          f"{res.cv_str}{prof} [{card}]", flush=True)
    if cut:
        print(f"[19 e2e] a: CUT: {cut}; the run above is at batch {batch} [{card}]",
              flush=True)
    losses = np.concatenate([x.reshape(-1) for x in probe.losses])
    check(bool(np.isfinite(losses).all()) and all(
        np.isfinite(f["eval_loss"]) for f in res.folds), "19a non-finite loss")
    folds = sorted(os.listdir(os.path.join(save, "model")))
    check(folds == [f"fold{i}_backbone" for i in range(sizes["folds"])],
          f"19a saved {folds}")
    fold0 = os.path.join(save, "model", "fold0_backbone")
    saved = torch.load(os.path.join(fold0, "pytorch_model.bin"), weights_only=True)
    moved = max(float((saved[k] - v).abs().max()) for k, v in sd.items())
    check(sorted(saved) == sorted(sd) and moved > 0,
          f"19a saved backbone moved {moved} from the initial one")

    # card vs CPU from the same weights, at 2 layers of the published width
    L = E2E_CHECK["audio_layers"]
    small = dataclasses.replace(cfg, num_hidden_layers=L)
    small_sd = layer_prefix_sd(sd, "encoder.layers.", L)
    pre2 = os.path.join(d, "pretrain_check")
    write_seeded_checkpoint(pre2, name, small, small_sd)
    names = sorted(wavs)[: 2 * E2E_CHECK["clips"]]
    emos = np.arange(len(names)) % 2
    sets = {s: E2EDataset.build_audio(part, emos[: len(part)], np.zeros(len(part)), audio,
                                      n_seg=E2E_CHECK["nseg"], seg_len=sizes["seglen"])
            for s, part in (("train", names[::2]), ("test1", names[1::2]))}
    t0 = time.perf_counter()
    r = e2e_check(torch, e2e_args(e2e_name=name, pretrain_dir=pre2), sets, small_sd, dev,
                  E2E_CHECK["batch"])
    print(f"[19 e2e] a: card vs CPU from the same weights ({L} layers at full width, "
          f"{E2E_CHECK['batch']} clips x {E2E_CHECK['nseg']} segments a batch, dropout "
          f"off): {check_line(r)} ({time.perf_counter() - t0:.1f} s) [{card}]",
          flush=True)
    check(r["grad"] <= E2E_TOL and r["eval"] <= E2E_TOL, f"19a card vs CPU {r}")
    return dict(sd=sd, pretrain=pretrain, fold0=fold0, saved=saved, wavs=wavs)


def phase_e2e_readback(torch, card, d: str, dev: str, cfg, a: dict) -> None:
    """19b: ``extract_audio --finetuned_ckpt`` on 19a's fold-0 backbone,
    against the fine-tuned encoder as the trainer saved it; a checkpoint of
    the wrong width is refused."""
    from mertools_tpu_torch.cli import extract_audio
    from mertools_tpu_torch.encoders.wav2vec2 import load_hf_state_dict
    from mertools_tpu_torch.features import audio as ta

    names = sorted(a["wavs"])[:8]
    audio8 = os.path.join(d, "audio8")
    write_wavs(audio8, {n: a["wavs"][n] for n in names})
    argv = ["--model_name", "chinese-hubert-large", "--pretrain_dir", a["pretrain"],
            "--audio_dir", audio8, "--feature_level", "UTTERANCE", "--device", dev]
    t0 = time.perf_counter()
    quiet(extract_audio.main, argv + ["--save_dir", os.path.join(d, "ft"),
                                      "--finetuned_ckpt", a["fold0"]])
    t_cli = time.perf_counter() - t0
    got = {n: np.load(os.path.join(d, "ft", "chinese-hubert-large-UTT", f"{n}.npy"))
           for n in names}
    wavs = {n: a["wavs"][n].astype(np.float32) / 32768.0 for n in names}
    budget = 80 * SR      # the CLI's --batch_budget_sec default, so the batches match
    want = ta.AudioExtractor(cfg, load_hf_state_dict(a["saved"]), sample_budget=budget,
                             device=dev).extract(wavs, level="UTT")
    base = ta.AudioExtractor(cfg, a["sd"], sample_budget=budget, device=dev).extract(
        wavs, level="UTT")
    d_ft, d_base = rel_diff(got, want), rel_diff(base, want)
    bad_dir = os.path.join(d, "narrow")
    write_seeded_checkpoint(bad_dir, "", cfg, {
        k: (v[..., : v.shape[-1] // 2] if v.shape[-1] == cfg.hidden_size else v)
        for k, v in a["saved"].items()})
    try:
        quiet(extract_audio.main, argv + ["--save_dir", os.path.join(d, "bad"),
                                          "--finetuned_ckpt", bad_dir])
        refused = "not refused"
    except ValueError as exc:
        refused = str(exc)
    print(f"[19 e2e] b: extract_audio chinese-hubert-large --finetuned_ckpt "
          f"fold0_backbone on {len(names)} wavs ({t_cli:.1f} s with loading): UTT vs "
          f"the saved fine-tuned encoder {d_ft:.3e} (limit {FINETUNED_TOL}); the "
          f"pretrained encoder lies {d_base:.3e} from it; a half-width checkpoint: "
          f"{refused!r} [{card}]", flush=True)
    check(d_ft <= FINETUNED_TOL, f"19b finetuned vs saved {d_ft}")
    check(d_base > FINETUNED_TOL, f"19b the fine-tuned encoder equals the pretrained {d_base}")
    check("leaf shapes do not match the selected model architecture" in refused,
          f"19b half-width checkpoint: {refused}")


def phase_e2e_text_vision(torch, card, d: str, dev: str, tcfg, vcfg, sizes: dict) -> None:
    """19c: ``e2e_model`` on chinese-macbert-large (``tcfg``, through the
    stand-in tokenizer) and clip-vit-large-patch14 (``vcfg``, uint8 face
    crops resized on the device), one fold x one epoch of ``run_cv`` each
    from a seeded checkpoint, then the card against the CPU from the same
    weights."""
    from mertools_tpu_torch.core.config import Args
    from mertools_tpu_torch.data import loaders
    from mertools_tpu_torch.data.cv import kfold_indices
    from mertools_tpu_torch.data.e2e_dataset import E2EDataset
    from mertools_tpu_torch.encoders import bert as tb
    from mertools_tpu_torch.encoders import vit_clip as tc
    from mertools_tpu_torch.train import loop

    rng = np.random.default_rng(191)
    pretrain = os.path.join(d, "pretrain_tv")
    gen = torch.Generator(device=dev).manual_seed(19)
    tsd = {k: v.cpu() for k, v in tb.init_params(tcfg, gen).items()}
    vsd = {k: v.cpu() for k, v in tc.init_params(vcfg, gen).items()}
    write_seeded_checkpoint(pretrain, "chinese-macbert-large", tcfg, tsd)
    write_seeded_checkpoint(pretrain, "clip-vit-large-patch14", vcfg, vsd)
    n_t, n_v = sizes["text_clips"], sizes["video_clips"]
    csv_path = os.path.join(d, "trans.csv")
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["name", "chinese"])
        for i in range(n_t):
            w.writerow([f"t{i:03d}", "" if i == 0 else CharTokenizer.sentence(
                rng, int(rng.integers(8, 97)))])
    faces = os.path.join(d, "faces")
    os.makedirs(faces)
    for i, clip in enumerate(face_clips(rng, n_v).values()):
        np.save(os.path.join(faces, f"v{i:03d}.npy"), clip)
    for modality, name, n, extra, sd in (
            ("text", "chinese-macbert-large", n_t, dict(trans_csv=csv_path), tsd),
            ("video", "clip-vit-large-patch14", n_v, dict(face_npy_root=faces), vsd)):
        names = [f"{modality[0]}{i:03d}" for i in range(n)]
        emos = np.arange(n) % 6
        args = Args(model="e2e_model", e2e_name=name, pretrain_dir=pretrain,
                    hidden_dim=256, dropout=0.3, lr=1e-5, l2=1e-5, grad_clip=-1.0,
                    batch_size=sizes["batch"], epochs=1, output_dim1=6,
                    output_dim2=0, metric_name="emo", **extra)
        with stand_in_tokenizer(CharTokenizer()):
            ds = loaders.MER2025Loader(args)._build(names, emos, np.zeros(n))
        fold = kfold_indices(n, 5, np.random.default_rng(0))[:1]
        t0 = time.perf_counter()
        res = quiet(loop.run_cv, args, ds, None, 0, True, fold, None, dev)[0]
        secs = time.perf_counter() - t0
        data = {k: v.shape for k, v in ds.arrays().items()}
        half = n // 2
        check_sets = {s: E2EDataset(ds.names[sl], ds.emos[sl], ds.vals[sl],
                                            ds.modality, {k: v[sl] for k, v in ds.data.items()})
                      for s, sl in (("train", slice(0, min(half, E2E_CHECK["clips"]))),
                                    ("test1", slice(half, half + E2E_CHECK["clips"] // 2)))}
        t0 = time.perf_counter()
        r = e2e_check(torch, e2e_args(e2e_name=name, pretrain_dir=pretrain, **extra),
                      check_sets, sd, dev, 2 if modality == "video" else E2E_CHECK["batch"])
        layers = (tcfg if modality == "text" else vcfg).num_hidden_layers
        print(f"[19 e2e] c: {name} ({layers} layers at full width) e2e_model, one fold x "
              f"one epoch of run_cv on {n} clips ({data}): {secs:.1f} s, eval "
              f"{res.cv_str}; card vs CPU from the same weights: {check_line(r)} "
              f"({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
        check(bool(np.isfinite(res.folds[0]["eval_loss"])), f"19c {name} loss")
        check(r["grad"] <= E2E_TOL and r["eval"] <= E2E_TOL, f"19c {name} card vs CPU {r}")


def int8_sites_equal(torch, enc_cls, cfg, sd: dict, x, dev: str) -> tuple[int, int]:
    """The int8 mode on the card against the CPU: a ``cfg`` encoder in bf16
    with :func:`int8_dot_general` recording each Dense site's operands and
    product on ``dev``; then, from the same operands, each site's
    activation and weight codes and scales on the CPU (bit-equal), the
    card's int32 sums against the exact int64 product of the codes
    (equal), and the card's product against the CPU's rescale of those
    exact sums within one unit in the last place of the output dtype (the
    card divides by a host scalar as a product with its reciprocal, which
    can move the last bit). Returns (sites, sites where the CPU's own
    ``torch._int_mm`` differs from the exact sums, products that differ
    from the CPU's rescale, products), the second printed, not gated: it is
    the host's GEMM, not the card's."""
    from mertools_tpu_torch.ops import quant

    sites, cpu_off, n_off, n_all = [], 0, 0, 0

    def recording(lhs, rhs):
        out = quant.int8_dot_general(lhs, rhs)
        sites.append((lhs.detach(), rhs.detach(), out.detach()))
        return out

    with torch.device("meta"):
        enc = enc_cls(cfg, dot_general=recording)
    enc.load_state_dict(sd, assign=True)
    with torch.inference_mode():
        enc.to(dev, torch.bfloat16).eval()(x.to(dev, torch.bfloat16))
    for i, (lhs, rhs, out) in enumerate(sites):
        codes = []
        for t, dim in ((lhs, -1), (rhs, 0)):
            q_dev, s_dev = quant.quantize_int8(t, dim)
            q_cpu, s_cpu = quant.quantize_int8(t.cpu(), dim)
            check(torch.equal(q_dev.cpu(), q_cpu) and torch.equal(s_dev.cpu(), s_cpu),
                  f"19d int8 site {i}: codes or scales differ from the CPU's")
            codes.append((q_dev, q_cpu, s_cpu))
        (ql, ql_cpu, ls), (qr, qr_cpu, rs) = codes
        ql_cpu = ql_cpu.reshape(-1, ql_cpu.shape[-1])
        # exact in float64: every partial sum is an integer below 127^2 K < 2^53
        exact = (ql_cpu.double() @ qr_cpu.double()).long()
        acc = quant.int_mm(ql.reshape(-1, ql.shape[-1]), qr).cpu().long()
        check(torch.equal(acc, exact), f"19d int8 site {i}: the card's int32 sums differ "
              f"from the exact product by {int((acc - exact).abs().max())}")
        cpu_off += not torch.equal(quant.int_mm(ql_cpu, qr_cpu).long(), exact)
        want = (exact.int().reshape(*ql.shape[:-1], -1).float() * (ls / 127.0)
                * (rs / 127.0)).to(out.dtype)
        got, want = out.cpu().float(), want.float()
        _, e = torch.frexp(want)      # |want| in [2^(e-1), 2^e): its ulp is eps 2^(e-1)
        ulp = torch.ldexp(torch.full_like(want, torch.finfo(out.dtype).eps), e - 1)
        gap = (got - want).abs()
        check(bool((gap <= ulp).all()), f"19d int8 site {i}: the product differs from "
              f"the CPU's rescale of the exact sums by {float((gap / ulp).max()):.2f} ulp")
        n_off += int((gap > 0).sum())
        n_all += gap.numel()
    return len(sites), cpu_off, n_off, n_all


def phase_int8(torch, card, dev: str, acfg, asd: dict, vcfg, vsd: dict,
               n_audio: int = 64, n_video: int = 32) -> None:
    """19d: HuBERT-large on the bench mix and CLIP-L on phase 14's clips at
    ``compute_dtype`` fp32, bf16 and int8: rates, UTT errors against fp32
    and the gate; then the int8 sites, card against CPU, at 2 layers."""
    from mertools_tpu_torch.encoders import vit_clip as tc
    from mertools_tpu_torch.encoders import wav2vec2 as tw
    from mertools_tpu_torch.features import audio as ta
    from mertools_tpu_torch.features import vision as tvis

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    lengths, _, wavs = bench_clips()
    wavs = dict(list(wavs.items())[:n_audio])
    audio_s = float(sum(len(w) for w in wavs.values())) / SR
    clips = dict(list(face_clips(np.random.default_rng(14), 32).items())[:n_video])
    n_frames = sum(min(len(c), 64) for c in clips.values())
    buckets, budget = (64000, 112000, ta.MAX_SEGMENT), 16 * ta.MAX_SEGMENT
    for label, make, data, warm, unit, n_unit in (
            ("HuBERT-large", lambda m: ta.AudioExtractor(
                acfg, asd, buckets=buckets, sample_budget=budget, compute_dtype=m,
                device=dev), wavs, {f"w{i}": np.zeros(b, np.float32)
                                    for i, b in enumerate(buckets)}, "clips", len(wavs)),
            ("CLIP-L/14", lambda m: tvis.VisionExtractor(
                vcfg, vsd, batch_size=64, max_frames=64, compute_dtype=m, device=dev),
             clips, dict(list(clips.items())[:1]), "frames", n_frames)):
        outs, rates = {}, {}
        for mode in ("fp32", "bf16", "int8"):
            ex = make(None if mode == "fp32" else mode)
            ex.extract(warm, level="UTT")
            sync()
            t0 = time.perf_counter()
            outs[mode] = ex.extract(data, level="UTT")
            sync()
            rates[mode] = n_unit / (time.perf_counter() - t0)
            del ex
        d = {m: rel_diff(outs[m], outs["fp32"]) for m in ("bf16", "int8")}
        ratio = int8_gate(d, f"19d {label}")
        extra = f" ({audio_s:.1f} s of audio)" if unit == "clips" else f" ({len(clips)} clips)"
        print(f"[19 e2e] d: {label} UTT {unit}/s{extra}: "
              f"{', '.join(f'{m} {r:.1f}' for m, r in rates.items())}; vs fp32, worst "
              f"clip's max|a - b| / max|b|: bf16 {d['bf16']:.3e}, int8 {d['int8']:.3e} "
              f"(int8 / bf16 = {ratio:.2f}, limit {INT8_RATIO}) [{card}]", flush=True)
    L = E2E_CHECK["audio_layers"]
    n_a, off_a, diff_a, all_a = int8_sites_equal(torch, tw.Wav2Vec2Encoder,
                           dataclasses.replace(acfg, num_hidden_layers=L),
                           layer_prefix_sd(asd, "encoder.layers.", L),
                           torch.from_numpy(ta.normalize_wav(next(iter(wavs.values())))[None]),
                           dev)
    from mertools_tpu_torch.features.vision import preprocess_faces_device

    pix = preprocess_faces_device(torch.from_numpy(next(iter(clips.values()))[:8]),
                                  vcfg.image_size)
    n_v, off_v, diff_v, all_v = int8_sites_equal(
        torch, tc.CLIPVisionEncoder, dataclasses.replace(vcfg, num_hidden_layers=L),
        layer_prefix_sd(vsd, "encoder.layers.", L), pix, dev)
    print(f"[19 e2e] d: int8 at {L} layers from the same operands: activation and "
          f"weight codes and scales card vs CPU bit-equal, the card's int32 sums equal "
          f"to the exact product, its bf16 products within 1 ulp of the CPU's rescale "
          f"of them ({diff_a} of {all_a} HuBERT and {diff_v} of {all_v} CLIP elements "
          f"differ), at all {n_a} HuBERT and {n_v} CLIP sites; the CPU's own "
          f"torch._int_mm differs from the exact sums at {off_a} + {off_v} of them "
          f"[{card}]", flush=True)


def phase_e2e(torch, card, dev: str = "cuda", acfg=None, tcfg=None, vcfg=None,
              audio=E2E_AUDIO, text_vision=E2E_TEXT_VISION, int8_sizes=(64, 32)) -> None:
    """Phase 19: e2e fine-tuning (a-c) and the int8 extraction mode (d), at
    HuBERT-large, MacBERT-large (3 layers) and CLIP-L/14 (2 layers) widths
    unless the configs say otherwise."""
    from mertools_tpu_torch.encoders.bert import BertConfig
    from mertools_tpu_torch.encoders.vit_clip import CLIPVisionConfig
    from mertools_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config
    from mertools_tpu_torch.encoders import vit_clip as tc

    acfg = acfg or Wav2Vec2Config.large()
    tcfg = tcfg or dataclasses.replace(BertConfig.large(),
                                       num_hidden_layers=E2E_CHECK["text_layers"])
    vfull = vcfg or CLIPVisionConfig()
    marks = [time.perf_counter()]
    with tempfile.TemporaryDirectory() as d:
        a = phase_e2e_audio(torch, card, d, dev, acfg, audio)
        marks.append(time.perf_counter())
        phase_e2e_readback(torch, card, d, dev, acfg, a)
        marks.append(time.perf_counter())
        phase_e2e_text_vision(torch, card, d, dev, tcfg, dataclasses.replace(
            vfull, num_hidden_layers=E2E_CHECK["vision_layers"]), text_vision)
        marks.append(time.perf_counter())
    if dev == "cuda":
        torch.cuda.empty_cache()
    vsd = tc.init_params(vfull, torch.Generator(device=dev).manual_seed(0))
    phase_int8(torch, card, dev, acfg, a["sd"], vfull, vsd, *int8_sizes)
    marks.append(time.perf_counter())
    parts = ", ".join(f"{p} {b - a_:.1f} s" for p, a_, b in zip("abcd", marks, marks[1:]))
    print(f"[19 e2e] phase 19 took {marks[-1] - marks[0]:.1f} s ({parts}) [{card}]",
          flush=True)


def e2e_phase(torch, wrappers, card) -> None:
    """Phase 19 with the kernels' counts set to 0 before it and read after
    it: the JAX e2e path builds its encoders without flash attention and
    the int8 product is an XLA dot, so no kernel of the port runs."""
    from mertools_tpu_torch.encoders.wav2vec2 import Wav2Vec2Config

    for w in wrappers:
        w.launches = 0
    phase_e2e(torch, card, acfg=dataclasses.replace(Wav2Vec2Config.large(),
                                                    num_hidden_layers=E2E_LAYERS))
    counts = no_launches(wrappers, "phase 19")
    print(f"[19 e2e] kernel launches in phase 19: {counts} [{card}]", flush=True)


# ------------------------------------------------- the audio zoo (phase 20)
ZOO_FAMILIES = ("vggish", "wav2vec1", "emotion2vec", "imagebind")
# reduced depth of the card-vs-CPU legs (VGGish and wav2vec 1.0 whole)
ZOO_CHECK_DEPTH = {"emotion2vec": dict(prenet_depth=1, depth=1),
                   "imagebind": dict(num_blocks=2)}
ZOO_CPU_TOL = 3e-4     # card vs CPU, same weights: max |card - cpu| / max |cpu|
ZOO_RAGGED_TOL = 5e-5  # a ragged batch vs each clip alone, on the card
ZOO_CLI_TOL = 1e-5     # a CLI store vs the extractor on the same weights
ZOO_PASSES = 3         # timed passes a level; the rate printed is their median
# the CLI's checkpoint files: emotion2vec at 1 + 1 blocks; the other
# loaders fix their configs (ImageBind's huge, 12 blocks)
ZOO_CLI_DEPTH = {"emotion2vec": dict(prenet_depth=1, depth=1)}
ZOO_CLI_NAMES = {"vggish": "vggish", "wav2vec1": "wav2vec-large",
                 "emotion2vec": "emotion2vec_base", "imagebind": "imagebind_huge"}


def zoo_clips():
    """Phase 3's 64 clips of 2-10 s (PCM16, seed 0) and 4 of 20-45 s (seed
    20), so the whole-clip buckets above 10 s are reached: name -> PCM16."""
    _, wavs16, _ = bench_clips()
    rng = np.random.default_rng(20)
    for i, L in enumerate(rng.integers(20 * SR, 45 * SR, size=4)):
        wavs16[f"long{i}"] = (rng.normal(size=int(L)) * 3000).astype(np.int16)
    return wavs16


def zoo_model(family: str, dev, seed: int, **fields):
    """(config, seeded state dict on ``dev``) of a family at its published
    width: VGGish, ``Wav2Vec1Config()``, emotion2vec base and ImageBind-huge
    audio, unless ``fields`` replace some of the config's."""
    import torch

    from mertools_tpu_torch.encoders import audio_zoo as z
    from mertools_tpu_torch.encoders import emotion2vec as e2v
    from mertools_tpu_torch.encoders import imagebind as ib

    gen = torch.Generator(device=dev).manual_seed(seed)
    if family == "vggish":
        return None, z.vggish_init_params(gen)
    if family == "wav2vec1":
        cfg = dataclasses.replace(z.Wav2Vec1Config(), **fields)
        return cfg, z.wav2vec1_init_params(cfg, gen)
    if family == "emotion2vec":
        cfg = dataclasses.replace(e2v.Emotion2VecConfig(), **fields)
        return cfg, e2v.init_params(cfg, gen)
    cfg = dataclasses.replace(ib.ImageBindAudioConfig(), **fields)
    return cfg, ib.init_params(cfg, gen)


def zoo_extractor(family: str, cfg, sd: dict, dev):
    from mertools_tpu_torch.features import audio as ta

    if family == "vggish":
        return ta.VGGishExtractor(sd, device=dev)
    if family == "wav2vec1":
        return ta.Wav2Vec1Extractor(sd, cfg, device=dev)
    if family == "emotion2vec":
        return ta.Emotion2VecExtractor(sd, cfg, device=dev)
    return ta.ImageBindAudioExtractor(cfg, sd, device=dev)


def zoo_extract(ex, wavs: dict, level: str) -> dict:
    """name -> features, with wav2vec 1.0's z and c under ``name/z`` and
    ``name/c``."""
    if hasattr(ex, "extract_zc"):
        zs, cs = ex.extract_zc(wavs, level)
        return {**{f"{n}/z": f for n, f in zs.items()}, **{f"{n}/c": f for n, f in cs.items()}}
    return ex.extract(wavs, level)


def kept_rows(family: str, n: int, cfg) -> int:
    """FRA rows a clip of ``n`` samples keeps, by the JAX trim rules, after
    truncation to the last whole-clip bucket (ImageBind: its 8 clips)."""
    from mertools_tpu_torch.encoders import audio_zoo as z
    from mertools_tpu_torch.encoders import emotion2vec as e2v
    from mertools_tpu_torch.features.audio import WHOLECLIP_BUCKETS

    n = min(n, WHOLECLIP_BUCKETS[-1])
    if family == "vggish":
        return z.vggish_patches(n)
    if family == "wav2vec1":
        return int(z.w2v1_out_lengths(n, cfg))
    if family == "emotion2vec":
        return max(int(e2v.out_lengths(n, cfg)), 1)
    return 8


def zoo_gate(value: float, limit: float, what: str) -> float:
    check(value <= limit, f"{what} {value:.3e} over {limit:.0e}")
    return value


def write_zoo_checkpoint(d: str, family: str, sd: dict) -> str:
    """The reference's checkpoint file of a family under ``d``, named as
    the CLI looks for it: a torchvggish state dict (``vggish.pt``); a
    fairseq ``wav2vec-large.pt`` (``args`` and ``model``); a funasr
    ``emotion2vec_base.pt`` (``cfg`` and ``model``, with an EMA teacher's
    and a decoder's keys the loader leaves out); an ``imagebind_huge.pth``
    with another modality's key and the postprocessor's logit scale."""
    import torch

    sd = {k: v.detach().cpu() for k, v in sd.items()}
    path = os.path.join(d, ZOO_CLI_NAMES[family] + (".pth" if family == "imagebind" else ".pt"))
    if family == "wav2vec1":
        blob = {"args": argparse.Namespace(arch="wav2vec"), "model": sd}
    elif family == "emotion2vec":
        teacher = {f"_ema.{k}": v for k, v in sd.items() if k.startswith("blocks.")}
        blob = {"cfg": {"model": {"_name": "data2vec_multi"}}, "model": {
            **sd, **teacher, "modality_encoders.AUDIO.decoder.proj.weight": torch.zeros(4, 4)}}
    elif family == "imagebind":
        blob = {**sd, "modality_trunks.vision.blocks.0.attn.bias_k": torch.zeros(1, 1, 4),
                "modality_postprocessors.audio.1.log_logit_scale": torch.tensor(3.0)}
    else:
        blob = sd
    torch.save(blob, path)
    return path


def zoo_profile(torch, ex, wavs: dict, dev) -> str:
    """One batch's profile (the first ``batch_size`` clips, or 4 videos) as
    phases 6, 7 and 10 print it; "not measured" off the card."""
    if torch.device(dev).type != "cuda":
        return "profile not measured (no card)"
    n = getattr(ex, "batch_size", getattr(ex, "batch_clips", 8))
    batch = dict(list(wavs.items())[:n])
    wall, *prof = device_profile(torch, lambda: zoo_extract(ex, batch, "UTT"))
    return f"profile of one UTT batch of {n}: wall {wall:.1f} ms, {profile_line(*prof, wall)}"


def cut_depth(family: str, cfg, sd: dict, depth: dict):
    """(config, state dict) of a model's first layers: ``depth`` replaces
    the config's depth fields, the state dict keeps the cut model's keys."""
    import torch

    from mertools_tpu_torch.encoders import emotion2vec as e2v
    from mertools_tpu_torch.encoders import imagebind as ib

    if not depth:
        return cfg, sd
    cfg = dataclasses.replace(cfg, **depth)
    with torch.device("meta"):
        model = e2v.Emotion2Vec(cfg) if family == "emotion2vec" else ib.ImageBindAudioEncoder(cfg)
    return cfg, {k: sd[k] for k in model.state_dict()}


def zoo_alone(torch, family: str, ex, wav: np.ndarray, dev) -> dict:
    """A clip run alone through an extractor's module, unpadded: part ->
    (rows, C) (wav2vec 1.0 unmasked, as the JAX package runs a clip)."""
    w = torch.from_numpy(wav).to(dev)[None]
    with torch.inference_mode():
        if family == "wav2vec1":
            res = ex.model(w)
            return {"/z": res["z"][0].cpu().numpy(), "/c": res["c"][0].cpu().numpy()}
        return {"": ex.model(w, torch.tensor([w.shape[1]], device=dev))[0][0].cpu().numpy()}


def phase_audio_zoo_family(torch, card, family: str, dev, wavs: dict, check_names,
                           ragged_names, d: str, fields: dict) -> dict:
    """20 (a)-(d) for one family; returns its readings."""
    from mertools_tpu_torch.cli import extract_audio
    from mertools_tpu_torch.io import wav as wav_io

    tag = f"[20 audio zoo] {family}"
    on_card = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    cfg, sd = zoo_model(family, dev, seed=20, **fields)
    ex = zoo_extractor(family, cfg, sd, dev)
    zoo_extract(ex, wavs, "UTT")              # warm every bucket's shapes
    sync()
    set_up = time.perf_counter() - t0
    out, rate = {}, {}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for level in ("UTT", "FRA"):
        rates = []
        for _ in range(ZOO_PASSES):
            t0 = time.perf_counter()
            out[level] = zoo_extract(ex, wavs, level)
            sync()
            rates.append(len(wavs) / (time.perf_counter() - t0))
        rate[level] = sorted(rates)    # the median is the middle pass
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
    for key, f in out["FRA"].items():
        rows = kept_rows(family, len(wavs[key.split("/")[0]]), cfg)
        check(f.shape[0] == rows and bool(np.isfinite(f).all()),
              f"{family} {key}: FRA {f.shape}, want {rows} rows, finite")
        u = out["UTT"][key]
        check(bool(np.isfinite(u).all()) and np.abs(u - f.mean(0)).max()
              <= 1e-5 * np.abs(f).max(), f"{family} {key}: UTT is not the FRA mean")
    audio_s = sum(len(w) for w in wavs.values()) / SR
    med = {lv: r[len(r) // 2] for lv, r in rate.items()}
    print(f"{tag} (a): set-up (weights, upload, a warm pass) {set_up:.1f} s; clips/s, the "
          f"median of {ZOO_PASSES} passes (slowest-fastest): UTT {med['UTT']:.2f} "
          f"({rate['UTT'][0]:.2f}-{rate['UTT'][-1]:.2f}), FRA {med['FRA']:.2f} "
          f"({rate['FRA'][0]:.2f}-{rate['FRA'][-1]:.2f}) ({len(wavs)} clips, "
          f"{audio_s:.1f} s of audio); peak {peak:.2f} GiB; FRA rows follow the trim rules "
          f"and UTT is their mean [{card}]", flush=True)
    print(f"{tag} (a): {zoo_profile(torch, ex, wavs, dev)} [{card}]", flush=True)

    # (b) card vs CPU from the same weights at ZOO_CHECK_DEPTH
    sub = {n: wavs[n] for n in check_names}
    ccfg, csd = cut_depth(family, cfg, sd, ZOO_CHECK_DEPTH.get(family, {}))
    got = zoo_extract(zoo_extractor(family, ccfg, csd, dev), sub, "FRA")
    want = zoo_extract(zoo_extractor(family, ccfg, {k: v.cpu() for k, v in csd.items()},
                                     "cpu"), sub, "FRA")
    cpu = zoo_gate(rel_diff(got, want), ZOO_CPU_TOL, f"{family} card vs CPU")

    # (c) rows of one ragged bucketed batch of (a) against each clip alone
    rag = None
    if family in ("emotion2vec", "wav2vec1"):
        alone = {f"{n}{part}": rows for n in ragged_names
                 for part, rows in zoo_alone(torch, family, ex, wavs[n], dev).items()}
        rag = zoo_gate(rel_diff({k: out["FRA"][k] for k in alone}, alone), ZOO_RAGGED_TOL,
                       f"{family} ragged batch vs alone")
    del ex

    # (d) extract_audio on a reference-layout checkpoint file
    lcfg, lsd = cut_depth(family, cfg, sd, ZOO_CLI_DEPTH.get(family, {}))
    t0 = time.perf_counter()
    path = write_zoo_checkpoint(d, family, lsd)
    name, audio = ZOO_CLI_NAMES[family], os.path.join(d, "audio")
    quiet(extract_audio.main, ["--model_name", name, "--pretrain_dir", d, "--audio_dir", audio,
                               "--save_dir", os.path.join(d, "f"), "--feature_level", "FRAME",
                               "--device", "cuda" if on_card else "cpu"])
    cli_s = time.perf_counter() - t0
    read = {os.path.splitext(f)[0]: wav_io.read_wav_16k(os.path.join(audio, f))
            for f in sorted(os.listdir(audio))}
    want = zoo_extract(zoo_extractor(family, lcfg, lsd, dev), read, "FRA")
    stores = ([(f"{name}-z-FRA", "/z"), (f"{name}-c-FRA", "/c")] if family == "wav2vec1"
              else [(f"{name}-FRA", "")])
    got = {}
    for store, part in stores:
        files = sorted(os.listdir(os.path.join(d, "f", store)))
        check(files == sorted(f"{n}.npy" for n in read), f"{family} CLI store {store}: {files}")
        got.update({f"{n}{part}": np.load(os.path.join(d, "f", store, f"{n}.npy"))
                    for n in read})
    cli = zoo_gate(rel_diff(got, want), ZOO_CLI_TOL, f"{family} CLI vs extractor")
    print(f"{tag} (b) card vs CPU at {ZOO_CHECK_DEPTH.get(family) or 'full depth'} on "
          f"{len(sub)} clips: {cpu:.3e} (limit {ZOO_CPU_TOL:.0e}); (c) ragged vs alone: "
          + (f"{rag:.3e} (limit {ZOO_RAGGED_TOL:.0e})" if rag is not None else "not run")
          + f"; (d) extract_audio on {os.path.basename(path)} at "
          f"{ZOO_CLI_DEPTH.get(family) or 'full depth'} ({', '.join(s for s, _ in stores)}, "
          f"{len(read)} wavs, {cli_s:.1f} s with the write): {cli:.3e} from the extractor "
          f"(limit {ZOO_CLI_TOL:.0e}) [{card}]", flush=True)
    return {"utt_clips_s": med["UTT"], "fra_clips_s": med["FRA"], "peak_gib": peak,
            "cpu": cpu, "ragged": rag, "cli": cli}


def phase_audio_zoo(torch, card, dev: str = "cuda", wavs16=None, configs=None,
                    n_check: int = 4, n_cli: int = 6) -> dict:
    """20: the audio encoder zoo behind ``extract_audio`` at published
    width with seeded weights (``configs`` may replace a family's config
    fields, for a run at a small size):
    (a) each extractor on ``zoo_clips()``, UTT and FRA; (b) card vs CPU on
    the ``n_check`` shortest clips at ``ZOO_CHECK_DEPTH``; (c) for
    emotion2vec and wav2vec 1.0, four clips of one ragged batch against
    each run alone; (d) ``extract_audio`` on a reference-layout checkpoint
    file, on ``n_cli`` of the clips written as wavs."""
    wavs16 = wavs16 if wavs16 is not None else zoo_clips()
    wavs = {n: w.astype(np.float32) / 32768.0 for n, w in wavs16.items()}
    by_len = sorted(wavs, key=lambda n: len(wavs[n]))
    # four clips that shared a ragged batch in (a): the longest four of the
    # last bucket under 10 s
    ragged = [n for n in by_len if len(wavs[n]) <= 10 * SR][-4:]
    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as d:
        write_wavs(os.path.join(d, "audio"), {n: wavs16[n] for n in by_len[:n_cli]})
        for family in ZOO_FAMILIES:
            res[family] = phase_audio_zoo_family(torch, card, family, dev, wavs,
                                                 by_len[:n_check], ragged, d,
                                                 (configs or {}).get(family, {}))
            if torch.device(dev).type == "cuda":
                torch.cuda.empty_cache()
    print(f"[20 audio zoo] phase 20 took {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return res


def audio_zoo_phase(torch, wrappers, card) -> dict:
    """Phase 20 with the kernels' counts set to 0 before it and read after
    it: the JAX zoo's attention is a dense einsum and its spectra are
    ``jnp.fft``, so no kernel of the port runs."""
    for w in wrappers:
        w.launches = 0
    res = phase_audio_zoo(torch, card)
    counts = no_launches(wrappers, "phase 20")
    print(f"[20 audio zoo] kernel launches in phase 20: {counts} [{card}]", flush=True)
    return counts


# ------------------------------------------- handcrafted features (phase 21)
HC_SETS = ("mel_spec", "mfcc", "IS09", "eGeMAPS", "IS10", "IS13")
HC_OPENSMILE = ("IS09", "eGeMAPS", "IS10", "IS13")
HC_LEVELS = ("UTTERANCE", "FRAME")
HC_PASSES = 3          # timed passes a set and level; the rate printed is their median
# the sets phase 21 (a) profiles: IS13 runs both frame loops of B11 (the
# Viterbi pass of IS10's pitch branch and RASTA's pole); all six sets' 12 s
# bucket took 20.3 s of profiling (PR 17), the cut that makes room for phase 22
HC_PROFILED = ("IS13",)
HC_CPU_TOL = 1e-4      # card vs CPU: max |card - cpu| <= 1e-4 max |cpu| of a column, or 1e-6
HC_CLI_CLIPS = 16


def hc_rows(fs: str, n: int) -> int:
    """FRAME rows of a clip of ``n`` samples by the JAX rules, after the
    CLI's cut to 30 s: complete frames for the openSMILE sets (at least
    one), ``n // 160 + 1`` for librosa's."""
    n = min(n, 30 * SR)
    if fs in ("IS09", "IS10", "IS13"):
        return max(1 + (n - 400) // 160, 1)
    if fs == "eGeMAPS":
        return max(1 + (max(n, 960) - 960) // 160, 1)
    return n // 160 + 1


def hc_dims_gate(fs: str, level: str, feats: dict, lengths: dict) -> None:
    """Every store finite, of the set's width, FRAME rows (and the librosa
    sets' UTT rows) by :func:`hc_rows`."""
    from mertools_tpu_torch.ops.handcrafted import FRAME_DIMS, UTT_DIMS

    width = {"mel_spec": 128, "mfcc": 120}.get(
        fs, (UTT_DIMS if level == "UTTERANCE" else FRAME_DIMS).get(fs))
    for n, f in feats.items():
        want = (width,) if fs in UTT_DIMS and level == "UTTERANCE" \
            else (hc_rows(fs, lengths[n]), width)
        check(f.shape == want and bool(np.isfinite(f).all()),
              f"{fs} {level} {n}: {f.shape}, want {want}, finite")


def handcrafted_clips():
    """Phase 3's 64 clips of 2-10 s (PCM16, seed 0) and 4 of 20-30 s (seed
    21, one of exactly 20 s), so the 12, 20 and 30 s buckets are reached:
    name -> PCM16."""
    _, wavs16, _ = bench_clips()
    rng = np.random.default_rng(21)
    for i, L in enumerate([20 * SR, *rng.integers(20 * SR + 1, 30 * SR + 1, size=3)]):
        wavs16[f"long{i}"] = (rng.normal(size=int(L)) * 3000).astype(np.int16)
    return wavs16


def hc_tone(f0: float, n: int, seed: int, snr_db: float = 20.0) -> np.ndarray:
    """A harmonic tone (8 partials at 0.6^k, 5 Hz vibrato of 2%) in white
    noise at ``snr_db``, as the CPU tests draw it."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.02 * np.sin(2 * np.pi * 5 * t))) / SR
    x = sum(0.6 ** k * np.sin((k + 1) * phase) for k in range(8))
    x = 0.3 * x / np.abs(x).max()
    return (x + rng.normal(size=n) * np.sqrt(np.mean(x ** 2) / 10 ** (snr_db / 10))
            ).astype(np.float32)


def hc_check_clips() -> dict:
    """(b)'s four clips: a 2 s tone at 140 Hz with 0.3 s of silence, 1.7 s
    at 380 Hz, 5 s at 400 Hz, 1 s of noise. IS09's voicing holds the 140
    Hz tone unvoiced and the others voiced, each 0.06 or more from the
    cutoff, so no decision sits on a tie."""
    a = hc_tone(140.0, 2 * SR, 0)
    a[12000:16800] = 0.0
    noise = (np.random.default_rng(3).normal(size=SR) * 0.05).astype(np.float32)
    return {"tone140": a, "tone380": hc_tone(380.0, 27531, 1), "tone400": hc_tone(400.0, 5 * SR, 2),
            "noise": noise}


def hc_alone(torch, fs: str, wav: np.ndarray, dev) -> dict:
    """A clip's stores at both levels computed alone at its exact length (no
    bucket); an openSMILE set's from one contour computation."""
    from mertools_tpu_torch.ops import handcrafted as hc

    with torch.inference_mode():
        x = torch.from_numpy(wav)[None].to(dev)
        n = torch.tensor([len(wav)], device=dev)
        if fs in HC_OPENSMILE:
            utt, f, m = hc.handcrafted_levels(x, n, SR, fs)
            return {"UTTERANCE": utt[0].cpu().numpy(), "FRAME": f[0][m[0]].cpu().numpy()}
        fn = hc.mel_spec_librosa if fs == "mel_spec" else hc.mfcc_librosa
        frames = fn(x, SR)[0][: len(wav) // 160 + 1].cpu().numpy()
        return {"UTTERANCE": frames, "FRAME": frames}


def hc_profiles(torch, ex, items, sets) -> dict:
    """Each set's UTT extraction of one bucket, all in one profiler session
    (each set in its own host range): per set a line with its idle share,
    top device ops and the busy ms of the Viterbi (eGeMAPS, IS10, IS13) and
    RASTA (IS13) loops, the device time taken from what each range's host
    ops launched (``linked_busy_ms``); a set whose ops launched nothing the
    profiler recorded says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mertools_tpu_torch.ops.egemaps import VITERBI_RANGE
    from mertools_tpu_torch.ops.opensmile_is13 import RASTA_RANGE

    walls = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fs in sets:
            with record_function(f"hc.{fs}"):
                t0 = time.perf_counter()
                ex(items, fs, "UTTERANCE")
                torch.cuda.synchronize()
                walls[fs] = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def spans_of(name):
        return [(e.time_range.start, e.time_range.end) for e in ops if e.name == name]

    lines = {}
    for fs in sets:
        (a, b), = spans_of(f"hc.{fs}")
        busy, by = linked_busy_ms(ops, [(a, b)])
        head = f"profile of the 12 s bucket ({len(items)} clips): wall {walls[fs]:.1f} ms, "
        if not busy:
            lines[fs] = head + ("no device event linked to its host ops recorded: idle share "
                                "not measured")
            continue
        tops = ", ".join(f"{n[:60]} {t:.1f} ms" for n, t in
                         sorted(by.items(), key=lambda kv: -kv[1])[:5])
        line = head + (f"device busy {busy:.1f} ms (the kernels, memcpys and memsets its host "
                       f"ops launched), idle share {1 - busy / walls[fs]:.3f}; top device ops: "
                       f"{tops}")
        for label, rng in (("Viterbi", VITERBI_RANGE), ("RASTA", RASTA_RANGE)):
            loops = [(s, t) for s, t in spans_of(rng) if a <= s and t <= b]
            if loops:
                loop, _ = linked_busy_ms(ops, loops)
                line += (f"; {label} loop {loop:.1f} ms busy of {busy:.1f} ({loop / busy:.3f}), "
                         f"its host range {sum(t - s for s, t in loops) / 1e3:.1f} ms of the "
                         f"{walls[fs]:.1f} ms wall")
        lines[fs] = line
    return lines


def hc_utt_gate(torch, fs: str, items, dev, tol: float, what: str):
    """IS10 / IS13 UTT functionals on ``dev`` against the CPU by
    :func:`hc_explain`, a bucket batch at a time (the batches
    ``extract_batch`` makes), each side's from one contour pass on its
    device, the CPU's engine as the reference (float64 too, so "rounding"
    is an account): (worst column over its allowance, the columns off it
    with their accounts, {device: seconds})."""
    from mertools_tpu_torch.cli.extract_handcrafted import BUCKET_S, _buckets
    from mertools_tpu_torch.ops import opensmile_is10 as t10
    from mertools_tpu_torch.ops import opensmile_is13 as t13

    mod = t10 if fs == "IS10" else t13
    worst, explained, secs = 0.0, [], {"card": 0.0, "cpu": 0.0}
    engine, engine64 = port_engine(fs), port_engine(fs, True)
    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)

    def run(x, n, side):
        t0 = time.perf_counter()
        parts = mod._lld_core(x, n)
        utt = mod.utt_functionals(*parts).cpu().numpy()
        sync()
        secs[side] += time.perf_counter() - t0
        cpu = [{k: v.cpu() for k, v in p.items()} if isinstance(p, dict) else p.cpu()
               for p in parts]
        return utt, mod.functional_blocks(*cpu)

    with torch.inference_mode():
        for edge, group in _buckets(items, [SR * s for s in BUCKET_S]).items():
            for i in range(0, len(group), 32):
                part = group[i: i + 32]
                wavs = np.zeros((len(part), edge), np.float32)
                for j, (_, w) in enumerate(part):
                    wavs[j, : len(w)] = w
                x, n = torch.from_numpy(wavs), torch.tensor([len(w) for _, w in part])
                got, got_blocks = run(x.to(dev), n.to(dev), "card")
                want, want_blocks = run(x, n, "cpu")
                w_, ex_ = hc_explain(fs, got, want, got_blocks, want_blocks, engine, tol, what,
                                     engine64)
                worst = max(worst, w_)
                explained += [(part[e[1]][0], *e) for e in ex_]
    return worst, explained, secs


def hc_accounts(explained) -> str:
    """(b)'s words for the columns off HC_CPU_TOL: each account's count, its
    largest detail (the distance in the account's unit, which it holds to
    its slack) and its first entries with the clip, both values and the
    detail."""
    if not explained:
        return "none off it"
    by = {}
    for clip, name, _, how, g, w, detail in explained:
        by.setdefault(how, []).append((detail, f"{name} on {clip} {g:.6g} vs {w:.6g} "
                                               f"({detail:.3g})"))
    return "; ".join(f"{how} {len(v)} (largest {max(d for d, _ in v):.3g}): "
                     + ", ".join(t for _, t in v[:4]) for how, v in sorted(by.items()))


def phase_handcrafted(torch, card, dev: str = "cuda", wavs16=None, check_clips=None,
                      passes: int = HC_PASSES) -> dict:
    """21: the handcrafted sets behind ``extract_handcrafted`` (mel_spec,
    mfcc, IS09, eGeMAPS, IS10, IS13; fp32, TF32 off): (a) each set at UTT
    and FRA through ``extract_batch`` on ``handcrafted_clips()``, a warm
    pass then ``passes`` timed ones: clips/s (median, slowest-fastest), peak
    memory, stores finite at their dims and FRA rows by the JAX rules, then
    the 12 s bucket of each set of HC_PROFILED in one profiler session; (b) four tone clips on
    the card against the CPU (``hc_gate`` at HC_CPU_TOL; IS10's and IS13's
    UTT by ``hc_explain``, its accounts printed), the CPU's clips/s beside
    the card's; (c) the 6 s bucket's rows against each clip alone at its
    exact length (the openSMILE sets gated at HC_RAGGED_TOL of max |clip|;
    the librosa sets printed, their floor and padding depend on the
    buffer); (d) ``extract_handcrafted.main`` on HC_CLI_CLIPS wavs it writes,
    each store equal to ``extract_batch`` on the clips read back."""
    from mertools_tpu_torch.cli import extract_handcrafted as cli
    from mertools_tpu_torch.io import wav as wav_io

    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    wavs16 = wavs16 if wavs16 is not None else handcrafted_clips()
    items = [(n, w.astype(np.float32) / 32768.0) for n, w in wavs16.items()]
    lengths = {n: len(w) for n, w in items}
    audio_s = sum(lengths.values()) / SR

    def ex(its, fs, level, sr=SR, device=dev):
        return cli.extract_batch(its, fs, level, sr, 32, device)

    res = {}
    for fs in HC_SETS:
        t_set = time.perf_counter()
        ex(items, fs, "UTTERANCE")          # warm every bucket's shapes
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        rate = {}
        for level in HC_LEVELS:
            rates = []
            for _ in range(passes):
                sync()
                t0 = time.perf_counter()
                out = ex(items, fs, level)
                rates.append(len(items) / (time.perf_counter() - t0))
            hc_dims_gate(fs, level, out, lengths)
            rate[level] = sorted(rates)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
        med = {lv: r[len(r) // 2] for lv, r in rate.items()}
        print(f"[21 handcrafted] {fs} (a): clips/s, the median of {passes} passes "
              f"(slowest-fastest): UTT {med['UTTERANCE']:.2f} ({rate['UTTERANCE'][0]:.2f}-"
              f"{rate['UTTERANCE'][-1]:.2f}), FRA {med['FRAME']:.2f} ({rate['FRAME'][0]:.2f}-"
              f"{rate['FRAME'][-1]:.2f}) ({len(items)} clips, {audio_s:.1f} s of audio); peak "
              f"{peak:.2f} GiB; stores finite at their dims, FRA rows by the JAX rules "
              f"({time.perf_counter() - t_set:.1f} s) [{card}]", flush=True)
        res[fs] = {"utt_clips_s": med["UTTERANCE"], "fra_clips_s": med["FRAME"], "peak_gib": peak}
    bucket12 = [(n, w) for n, w in items if 8 * SR < len(w) <= 12 * SR]
    t0 = time.perf_counter()
    profiles = hc_profiles(torch, ex, bucket12, HC_PROFILED) if on_card else {}
    for fs in HC_PROFILED:
        print(f"[21 handcrafted] {fs} (a): "
              f"{profiles.get(fs, 'profile not measured (no card)')} [{card}]", flush=True)
    print(f"[21 handcrafted] (a): the profile session and its reading took "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    # (b) card vs CPU on four tone clips
    tones = list((check_clips or hc_check_clips()).items())
    for fs in HC_SETS:
        worst, secs, accounts = {}, {"card": 0.0, "cpu": 0.0}, ""
        t_set = time.perf_counter()
        for level in HC_LEVELS:
            if fs in ("IS10", "IS13") and level == "UTTERANCE":
                worst[level], explained, t = hc_utt_gate(torch, fs, tones, dev, HC_CPU_TOL,
                                                         "card vs CPU")
                secs = {k: v + t[k] for k, v in secs.items()}
                accounts = f"; UTT columns off it: {hc_accounts(explained)}"
                continue
            sync()
            t0 = time.perf_counter()
            got = ex(tones, fs, level)
            secs["card"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            want = ex(tones, fs, level, device="cpu")
            secs["cpu"] += time.perf_counter() - t0
            worst[level] = hc_gate(fs, level, got, want, HC_CPU_TOL, "card vs CPU")
        res[fs]["cpu"] = max(worst.values())
        print(f"[21 handcrafted] {fs} (b): card vs CPU on {len(tones)} tone clips, worst column "
              f"at {worst['UTTERANCE']:.3f} (UTT) and {worst['FRAME']:.3f} (FRA) of its allowance "
              f"({HC_CPU_TOL:.0e} of max |CPU|), discrete columns equal{accounts}; clips/s over "
              f"both levels: card {2 * len(tones) / secs['card']:.2f}, CPU "
              f"{2 * len(tones) / secs['cpu']:.2f} ({time.perf_counter() - t_set:.1f} s) "
              f"[{card}]", flush=True)

    # (c) the 6 s bucket's rows against each clip alone
    bucket6 = [(n, w) for n, w in items if 4 * SR < len(w) <= 6 * SR]
    for fs in HC_SETS:
        gated = fs in HC_OPENSMILE
        worst, t_set = 0.0, time.perf_counter()
        batched = {lv: ex(bucket6, fs, lv) for lv in HC_LEVELS}
        for n, w in bucket6:
            alone = hc_alone(torch, fs, w, dev)
            for lv in HC_LEVELS:
                scale = float(np.abs(alone[lv]).max())
                worst = max(worst, hc_gate(fs, lv, {n: batched[lv][n]}, {n: alone[lv]},
                                           HC_RAGGED_TOL, "ragged vs alone", scale) if gated
                            else float(np.abs(batched[lv][n] - alone[lv]).max()) / scale)
        res[fs]["ragged"] = worst
        print(f"[21 handcrafted] {fs} (c): the 6 s bucket's {len(bucket6)} ragged rows vs each "
              f"clip alone: " + (f"worst column at {worst:.3f} of its allowance "
                                 f"({HC_RAGGED_TOL:.0e} of max |clip|)" if gated else
                                 f"{worst:.3e} of max |clip| (printed, not gated: the dB floor is "
                                 f"the batch's max and the centre padding reads the buffer)")
              + f" ({time.perf_counter() - t_set:.1f} s) [{card}]", flush=True)

    # (d) extract_handcrafted.main on wavs it writes
    names = sorted(wavs16, key=lambda n: len(wavs16[n]))
    cli_names = names[:: max(len(names) // HC_CLI_CLIPS, 1)][:HC_CLI_CLIPS]
    with tempfile.TemporaryDirectory() as d:
        audio = os.path.join(d, "audio")
        write_wavs(audio, {n: wavs16[n] for n in cli_names})
        # in the CLI's file order, so both make the same batches row for row
        read = [(n, wav_io.read_wav_16k(os.path.join(audio, f"{n}.wav")))
                for n in sorted(cli_names)]
        t0 = time.perf_counter()
        for fs in HC_SETS:
            for level in HC_LEVELS:
                quiet(cli.main, [f"--feature_set={fs}", f"--feature_level={level}",
                                 f"--audio_dir={audio}", f"--save_dir={os.path.join(d, 'f')}",
                                 "--device", dev])
                want = ex(read, fs, level)
                store = os.path.join(d, "f", f"{fs}-{'UTT' if level == 'UTTERANCE' else 'FRA'}")
                check(sorted(os.listdir(store)) == sorted(f"{n}.npy" for n in cli_names),
                      f"CLI store {store}")
                for n in cli_names:
                    check(np.array_equal(np.load(os.path.join(store, f"{n}.npy")), want[n]),
                          f"CLI {fs} {level} {n} differs from extract_batch")
        cli_s = time.perf_counter() - t0
    print(f"[21 handcrafted] (d): extract_handcrafted.main, {len(HC_SETS)} sets x 2 levels on "
          f"{len(cli_names)} wavs ({cli_s:.1f} s with extract_batch's), every store equal to "
          f"extract_batch on the clips read back [{card}]", flush=True)
    print(f"[21 handcrafted] phase 21 took {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return res


def handcrafted_phase(torch, wrappers, card) -> dict:
    """Phase 21 with the kernels' counts set to 0 before it and read after
    it: the JAX chains' spectra are ``jnp.fft`` and their products einsums,
    outside any Pallas kernel, so no kernel of the port runs."""
    for w in wrappers:
        w.launches = 0
    res = phase_handcrafted(torch, card)
    counts = no_launches(wrappers, "phase 21")
    print(f"[21 handcrafted] kernel launches in phase 21: {counts} [{card}]", flush=True)
    return res


# ------------------------------------------------- the vision zoo (phase 22)
VZ_FAMILIES = ("dinov2", "data2vec", "videomae", "siglip", "eva_clip_g")
VZ_PASSES = 3          # timed passes a level and dtype; the rate printed is their median
VZ_CHECK_LAYERS = 2    # card vs CPU and the CLI's 2-layer checkpoints, at full width
VZ_TOME = ("dinov2", "siglip", "eva_clip_g")
VZ_CLI_TOL = 1e-5      # a CLI store vs the extractor on the same weights
VZ_CLI_NAMES = {"dinov2": "dinov2-large", "data2vec": "data2vec-vision-base",
                "videomae": "videomae-large", "siglip": "siglip-so400m-patch14-384",
                "eva_clip_g": "eva-clip-g"}
VZ_BATCH = {"videomae": 8}   # clips a VideoMAE batch; frames a batch elsewhere: 64


def vz_clips(n: int = 16) -> dict:
    """Phase 22's face crops as the OpenFace step writes them (112 x 112 BGR
    uint8): ``n`` clips of 8-80 frames, seed 22; the first has 80 (over 64,
    so DINOv2, EVA-G and SigLIP resample), the second 8 (under 16, so
    VideoMAE repeat-pads)."""
    rng = np.random.default_rng(22)
    lengths = [80, 8, *rng.integers(10, 49, n - 2)]
    return {f"face{i:02d}": rng.integers(0, 256, (int(t), 112, 112, 3), np.uint8)
            for i, t in enumerate(lengths)}


def vz_config(family: str, **fields):
    """A family's published geometry (DINOv2-large at 518 px,
    data2vec-vision-base, VideoMAE-large, SigLIP-so400m at 384 px,
    EVA-CLIP-G at 224 px), ``fields`` replacing some of its fields."""
    from mertools_tpu_torch.encoders import siglip as ts
    from mertools_tpu_torch.encoders import vit as tv

    large = dict(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096)
    cfg = {"dinov2": lambda: tv.dinov2_config(**large, image_size=518),
           "data2vec": lambda: tv.beit_config(hidden_size=768, num_layers=12, num_heads=12,
                                              intermediate_size=3072, image_size=224),
           "videomae": lambda: tv.videomae_config(**large, image_size=224),
           "siglip": ts.SiglipVisionConfig,
           "eva_clip_g": lambda: tv.eva_clip_g_config(image_size=224)}[family]()
    return dataclasses.replace(cfg, **fields)


def vz_init(family: str, cfg, dev, seed: int) -> dict:
    import torch

    from mertools_tpu_torch.encoders import siglip as ts
    from mertools_tpu_torch.encoders import vit as tv

    gen = torch.Generator(device=dev).manual_seed(seed)
    return (ts if family == "siglip" else tv).init_params(cfg, gen)


def vz_extractor(family: str, cfg, sd: dict, dev, batch: bool = True, **kw):
    """The extractor the CLI builds for a family (max_frames 64), at phase
    22's batch sizes unless ``batch`` is False (the CLI's own)."""
    from mertools_tpu_torch.features import vision_zoo as vz

    if batch:
        kw["batch_size"] = VZ_BATCH.get(family, 64)
    if family == "videomae":
        return vz.VideoMAEExtractor(cfg, sd, device=dev, **kw)
    if family in ("dinov2", "data2vec"):
        return vz.vit_token_sum_extractor(cfg, sd, device=dev, **kw)
    make = (vz.siglip_token_mean_extractor if family == "siglip"
            else vz.eva_clip_g_token_mean_extractor)
    return make(cfg, sd, device=dev, max_frames=64, **kw)


def vz_units(family: str, clips: dict) -> int:
    """Frames (clips for VideoMAE) an extraction of ``clips`` forwards."""
    if family == "videomae":
        return len(clips)
    cap = None if family == "data2vec" else 64
    return sum(len(c) if cap is None else min(len(c), cap) for c in clips.values())


def vz_flops(cfg) -> float:
    """FLOP of one unit (a frame; a clip for VideoMAE): 2 x the dense sites'
    multiply-adds over the tokens, 4 N^2 H for the attention's two products
    a layer, and the patch conv."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    n_patch = cfg.num_patches
    N = getattr(cfg, "seq_len", n_patch)
    mlp = (3 if getattr(cfg, "use_swiglu", False) else 2) * H * I
    patch = 3 * cfg.patch_size ** 2 * (cfg.tubelet_size if getattr(cfg, "num_frames", 0) else 1)
    return cfg.num_layers * (2 * N * (4 * H * H + mlp) + 4 * N * N * H) + 2 * n_patch * patch * H


def vz_one_batch(family: str, clips: dict) -> dict:
    """The shortest clips whose units fit one batch (64 frames, 8 clips)."""
    out, n, cap = {}, 0, VZ_BATCH.get(family, 64)
    for name in sorted(clips, key=lambda m: len(clips[m])):
        k = vz_units(family, {name: clips[name]})
        if n + k > cap:
            break
        out[name], n = clips[name], n + k
    return out


def vz_rates(torch, ex, clips: dict, units: int, on_card: bool) -> tuple[dict, dict, float]:
    """A warm pass on two clips, then VZ_PASSES timed passes a level: (units/s
    a level sorted, the last pass's outputs a level, peak GiB)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ex.extract(dict(list(clips.items())[:2]), level="UTT")
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rates, outs = {}, {}
    for level in ("UTT", "FRA"):
        r = []
        for _ in range(VZ_PASSES):
            t0 = time.perf_counter()
            outs[level] = ex.extract(clips, level=level)
            sync()
            r.append(units / (time.perf_counter() - t0))
        rates[level] = sorted(r)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else float("nan")
    return rates, outs, peak


def vz_write_checkpoint(d: str, family: str, cfg, sd: dict) -> str:
    """A family's checkpoint as its publisher writes it, under ``d`` named
    as the CLI looks for it: ``config.json`` + ``pytorch_model.bin`` in HF's
    keys (DINOv2 with its ``mask_token``, data2vec with its pooler, SigLIP
    as a full ``SiglipModel`` with a text-tower key and ``logit_scale``), or
    BLIP-2's ``eva-clip-g.pth`` of timm keys."""
    import torch

    from mertools_tpu_torch.core.checkpoint import write_hf_checkpoint
    from mertools_tpu_torch.encoders import vit as tv

    path = os.path.join(d, VZ_CLI_NAMES[family])
    if family == "eva_clip_g":
        torch.save(tv.hf_state_dict(cfg, sd), path + ".pth")
        return path + ".pth"
    if family == "siglip":
        config = {"model_type": "siglip", "vision_config": cfg.to_config_json()}
        w = {**{k: v.cpu() for k, v in sd.items()},
             "text_model.embeddings.token_embedding.weight": torch.zeros(4, 4),
             "logit_scale": torch.tensor(2.3)}
        return write_hf_checkpoint(path, config, w)
    common = dict(hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
                  num_attention_heads=cfg.num_heads, image_size=cfg.image_size,
                  patch_size=cfg.patch_size, layer_norm_eps=cfg.layer_norm_eps)
    w = tv.hf_state_dict(cfg, sd)
    H = cfg.hidden_size
    if family == "dinov2":
        config = dict(common, model_type="dinov2", mlp_ratio=cfg.intermediate_size // H,
                      layerscale_value=cfg.layerscale, use_swiglu_ffn=False)
        w["embeddings.mask_token"] = torch.zeros(1, H)
    elif family == "data2vec":
        config = dict(common, model_type="data2vec-vision",
                      intermediate_size=cfg.intermediate_size,
                      layer_scale_init_value=cfg.layerscale,
                      use_absolute_position_embeddings=False,
                      use_relative_position_bias=True, use_mean_pooling=True)
        w.update({"pooler.layernorm.weight": torch.ones(H), "pooler.layernorm.bias": torch.zeros(H)})
    else:
        config = dict(common, model_type="videomae", intermediate_size=cfg.intermediate_size,
                      num_frames=cfg.num_frames, tubelet_size=cfg.tubelet_size,
                      qkv_bias=True, use_mean_pooling=True)
    return write_hf_checkpoint(path, config, w)


def vz_layers_sd(family: str, sd: dict, n: int) -> dict:
    return layer_prefix_sd(sd, "encoder.layers." if family == "siglip" else "blocks.", n)


def phase_vision_zoo_family(torch, card, family: str, dev, clips: dict, fields: dict,
                            n_check: int) -> dict:
    """22 (a)-(e) for one family; returns its readings."""
    from mertools_tpu_torch.cli import extract_vision

    tag = f"[22 vision zoo] {family}"
    on_card = torch.device(dev).type == "cuda"
    unit = "clips" if family == "videomae" else "frames"
    t0 = time.perf_counter()
    cfg = vz_config(family, **fields)
    sd = vz_init(family, cfg, dev, seed=22)
    n_params = sum(v.numel() for v in sd.values())
    res = {}
    # (a) bf16 on the whole mix, fp32 on one batch; (c) bf16 vs fp32
    one = vz_one_batch(family, clips)
    outs = {}
    for mode, data in (("bf16", clips), ("fp32", one)):
        ex = vz_extractor(family, cfg, sd, dev, compute_dtype="bf16" if mode == "bf16" else None)
        units = vz_units(family, data)
        rates, outs[mode], peak = vz_rates(torch, ex, data, units, on_card)
        med = {lv: r[len(r) // 2] for lv, r in rates.items()}
        prof = "profile not measured (no card)"
        if on_card:
            wall, *p = device_profile(torch, lambda: ex.extract(one, level="UTT"))
            prof = f"profile of one batch ({vz_units(family, one)} {unit}): wall {wall:.1f} ms, " \
                   f"{profile_line(*p, wall)}"
        tflops = vz_flops(cfg) * med["UTT"] / 1e12
        print(f"{tag} (a) {mode}: {unit}/s, the median of {VZ_PASSES} passes (slowest-fastest): "
              f"UTT {med['UTT']:.2f} ({rates['UTT'][0]:.2f}-{rates['UTT'][-1]:.2f}), FRA "
              f"{med['FRA']:.2f} ({rates['FRA'][0]:.2f}-{rates['FRA'][-1]:.2f}) on {len(data)} "
              f"clips, {units} {unit} ({tflops:.1f} TFLOP/s at UTT, {vz_flops(cfg) / 1e12:.3f} "
              f"TFLOP a unit); peak {peak:.2f} GiB; {prof} [{card}]", flush=True)
        res[mode] = {"utt": med["UTT"], "fra": med["FRA"], "peak_gib": peak}
        for name, f in outs[mode]["FRA"].items():
            rows = 8 if family == "videomae" else vz_units(family, {name: data[name]})
            check(f.shape[0] == rows and bool(np.isfinite(f).all()),
                  f"22 {family} {mode} FRA {name}: {f.shape}, want {rows} rows, finite")
        del ex
    bf = {n: outs["bf16"]["UTT"][n] for n in one}
    res["bf16_vs_fp32"] = zoo_gate(rel_diff(bf, outs["fp32"]["UTT"]), FEATURE_TOL["bf16"],
                                   f"22 {family} bf16 vs fp32 UTT")

    # (b) card vs CPU, fp32, the first VZ_CHECK_LAYERS layers at full width
    check_cfg = dataclasses.replace(cfg, num_layers=VZ_CHECK_LAYERS)
    check_sd = vz_layers_sd(family, sd, VZ_CHECK_LAYERS)
    few = {n: c[:1] if family != "videomae" else c for n, c in list(clips.items())[:n_check]}
    t1 = time.perf_counter()
    got = vz_extractor(family, check_cfg, check_sd, dev).extract(few, level="FRA")
    want = vz_extractor(family, check_cfg, check_sd, "cpu").extract(few, level="FRA")
    res["cpu"] = zoo_gate(rel_diff(got, want), FEATURE_TOL["cpu"], f"22 {family} card vs CPU")
    cpu_s = time.perf_counter() - t1

    # (d) ToMe r 8 beside the full tower, bf16
    tome = ""
    if family in VZ_TOME:
        sub = dict(list(clips.items())[:4])
        t1 = time.perf_counter()
        got = vz_extractor(family, dataclasses.replace(cfg, tome_r=8), sd, dev,
                           compute_dtype="bf16").extract(sub, level="UTT")
        dt = time.perf_counter() - t1
        for name, f in got.items():
            check(f.shape == (cfg.hidden_size,) and bool(np.isfinite(f).all()),
                  f"22 {family} ToMe {name}: {f.shape} or non-finite")
        res["tome"] = rel_diff(got, {n: outs["bf16"]["UTT"][n] for n in sub})
        tome = (f"; (d) ToMe r 8 (bf16) on {len(sub)} clips in {dt:.2f} s with set-up: UTT "
                f"({cfg.hidden_size},) finite, {res['tome']:.3e} of max from the full tower "
                f"(an approximation, no limit)")
    if on_card:
        torch.cuda.empty_cache()

    # (e) extract_vision.main on a checkpoint in the publisher's layout: DINOv2
    # at full depth in bf16, the others at VZ_CHECK_LAYERS layers in fp32
    full = family == "dinov2"
    ccfg, csd = (cfg, sd) if full else (check_cfg, check_sd)
    dtype = ["--compute_dtype", "bf16"] if full else []
    cli_clips = dict(list(clips.items())[:4])
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        faces = os.path.join(td, "faces")
        os.makedirs(faces)
        for n, c in cli_clips.items():
            np.save(os.path.join(faces, f"{n}.npy"), c)
        ckpt = vz_write_checkpoint(td, family, ccfg, csd)
        name = VZ_CLI_NAMES[family]
        quiet(extract_vision.main, ["--model_name", name, "--pretrain_dir", td,
                                    "--face_dir", faces, "--save_dir", td,
                                    "--feature_level", "UTTERANCE", "--device",
                                    "cuda" if on_card else "cpu", *dtype])
        store = os.path.join(td, f"{name}-UTT")
        check(sorted(os.listdir(store)) == sorted(f"{n}.npy" for n in cli_clips),
              f"22 {family} CLI store {os.listdir(store)}")
        feats = {n: np.load(os.path.join(store, f"{n}.npy")) for n in cli_clips}
    lib = vz_extractor(family, ccfg, csd, dev, batch=False,
                       compute_dtype="bf16" if full else None).extract(cli_clips, level="UTT")
    res["cli"] = zoo_gate(rel_diff(feats, lib), VZ_CLI_TOL, f"22 {family} CLI vs library")
    cli_s = time.perf_counter() - t1
    print(f"{tag}: {n_params / 1e6:.1f} M params; (c) bf16 vs fp32 UTT on the fp32 batch's "
          f"{len(one)} clips: {res['bf16_vs_fp32']:.3e} (limit {FEATURE_TOL['bf16']}); (b) card "
          f"vs CPU fp32 at {VZ_CHECK_LAYERS} layers, {len(few)} clips, FRA: {res['cpu']:.3e} "
          f"(limit {FEATURE_TOL['cpu']}; {cpu_s:.1f} s){tome}; (e) extract_vision.main on "
          f"{os.path.basename(ckpt)} ({'full depth, bf16' if full else f'{VZ_CHECK_LAYERS} layers, fp32'}"
          f", {len(cli_clips)} clips, {cli_s:.1f} s with the write): {res['cli']:.3e} from the "
          f"library (limit {VZ_CLI_TOL:.0e}); family {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    return res


def phase_vision_zoo(torch, card, dev: str = "cuda", clips=None, configs=None,
                     n_check: int = 4) -> dict:
    """22: the ViT vision zoo behind ``extract_vision`` at published width
    with seeded weights (``configs`` may replace a family's config fields,
    for a run at a small size): (a) bf16 on ``vz_clips()`` and fp32 on one
    batch, UTT and FRA; (b) card vs CPU at VZ_CHECK_LAYERS layers on
    ``n_check`` clips; (c) bf16 vs fp32; (d) ToMe r 8; (e) the CLI on a
    checkpoint in the publisher's layout."""
    clips = clips if clips is not None else vz_clips()
    t_phase = time.perf_counter()
    res = {family: phase_vision_zoo_family(torch, card, family, dev, clips,
                                           (configs or {}).get(family, {}), n_check)
           for family in VZ_FAMILIES}
    print(f"[22 vision zoo] phase 22 took {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return res


def vision_zoo_phase(torch, wrappers, card) -> dict:
    """Phase 22 with the kernels' counts set to 0 before it and read after
    it: the JAX ViT family's attention is a dense einsum, outside any Pallas
    kernel, so no kernel of the port runs."""
    for w in wrappers:
        w.launches = 0
    phase_vision_zoo(torch, card)
    counts = no_launches(wrappers, "phase 22")
    print(f"[22 vision zoo] kernel launches in phase 22: {counts} [{card}]", flush=True)
    return counts


def phase_clock(card):
    """``mark(phase)`` prints the seconds since this call when a phase ends,
    so a run's log gives every phase's share of the script's time."""
    t0 = time.perf_counter()
    last = [t0]

    def mark(phase: str) -> None:
        now = time.perf_counter()
        print(f"[time] phase {phase} ended {now - t0:.1f} s into the run, "
              f"{now - last[0]:.1f} s after the last mark [{card}]", flush=True)
        last[0] = now
    return mark


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
    alone = {"--fusion-zoo": zoo_phase, "--serving": serving_phase, "--e2e": e2e_phase,
             "--audio-zoo": audio_zoo_phase, "--handcrafted": handcrafted_phase,
             "--vision-zoo": vision_zoo_phase}
    if argv and (len(argv) > 1 or argv[0] not in alone):
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
    wrappers = [fa.flash_attention, mf.mel_power] + [getattr(fc, n) for n in B3_WRAPPERS]
    if argv:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        alone[argv[0]](torch, wrappers, card)
        return 0
    path, secs, log = _kernels.build()
    usage = check_no_spills(log)
    print(f"[1 device] kernels {os.path.relpath(path, HERE)}: built in "
          f"{secs:.1f} s{'' if secs else ' (reused, with its build log)'}; "
          f"ptxas -v (registers, spill store/load bytes): {usage} [{card}]",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mark = phase_clock(card)

    kres = phase_kernel(torch, fa, card)
    mark("2")
    launches, ex_bf16, _ = phase_extract(torch, fa, ta, tw, card)
    mark("3")
    phase_cli(torch, ex_bf16, card)
    del ex_bf16
    torch.cuda.empty_cache()
    mark("4")

    mres = phase_mel(torch, mel, mf, card, usage)
    mark("5")
    cfg, params, wavs, feat_launches, _ = phase_whisper_features(
        torch, mel, mf, tws, ta, card)
    mark("6")
    asr_launches, _ = phase_asr(torch, mf, tws, tasr, tdec, cfg, params, wavs, card)
    del params
    torch.cuda.empty_cache()
    mark("7")
    phase_cli_whisper(torch, mf, ta, card)
    torch.cuda.empty_cache()
    mark("8")

    b3 = phase_b3(torch, fc, card)
    mark("9")
    train_launches = phase_train(torch, fc, tga, tl, tq, tr, card)
    mark("10")
    phase_cli_train(torch, fc, card)
    mark("11")

    # the fusion trainer's path: counts start at 0 here and are read right
    # after it; it runs cuBLAS/cuDNN and none of the port's kernels
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
    mark("12")

    from mertools_tpu_torch.encoders.bert import BertConfig
    from mertools_tpu_torch.encoders.vit_clip import CLIPVisionConfig

    ex_text, text_launches, b1_text = phase_text(torch, fa, BertConfig.large(), card)
    mark("13")
    ex_vis, vision_launches, b1_vis = phase_vision(torch, fa, CLIPVisionConfig(), card)
    mark("14")
    tri_launches, handoff = phase_trimodal(torch, fa, ex_text, ex_vis, card)
    del ex_text
    torch.cuda.empty_cache()
    mark("15")
    face_launches = phase_faces(torch, fa, ex_vis, handoff, card)
    del ex_vis, handoff
    mark("16")
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

    torch.cuda.empty_cache()
    zoo_phase(torch, wrappers, card)
    torch.cuda.empty_cache()
    mark("17")
    serving_phase(torch, wrappers, card)
    torch.cuda.empty_cache()
    mark("18")
    e2e_phase(torch, wrappers, card)
    torch.cuda.empty_cache()
    mark("19")
    b1_paths["audio zoo (20)"] = audio_zoo_phase(torch, wrappers, card)["flash_attention"]
    torch.cuda.empty_cache()
    mark("20")
    handcrafted_phase(torch, wrappers, card)
    torch.cuda.empty_cache()
    mark("21")
    b1_paths["vision zoo (22)"] = vision_zoo_phase(torch, wrappers, card)["flash_attention"]
    mark("22")

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
