"""Noise-corruption CLI (``MER2023/main-corrupt.py`` equivalent, end-to-end)
— port of ``mertools_tpu/cli/main_corrupt.py``, with its flags and its
``random.Random(seed)`` draw order, so the SNR and blur of every clip equal
the JAX CLI's.

    python -m mertools_tpu_torch.cli.main_corrupt --video_root=.../video \
        --save_root=.../video-corrupted --noise_root=.../musan \
        --snr_low=5 --snr_high=10 --blur_low=2 --blur_high=4 [--device cpu]

Per clip: decode via the native libav frontend (no ffmpeg subprocess), mix
MUSAN-style noise into the audio at a random SNR, pyramid-blur the frames on
``--device`` (default ``cuda``, the card), and re-encode video+audio in one
native mux call — the reference shells out to ffmpeg three times per clip
(demux, blur re-encode, merge; main-corrupt.py:25-130).
"""

from __future__ import annotations

import argparse
import glob
import os
import random

import numpy as np


def main(argv=None):
    from ..data.corruption import blur_frames, mix_noise
    from ..io import video as vio
    from ..io import wav as wav_io

    p = argparse.ArgumentParser("main_corrupt")
    p.add_argument("--video_root", required=True)
    p.add_argument("--save_root", required=True)
    p.add_argument("--noise_root", default=None,
                   help="dir of noise wavs (MUSAN); gaussian if omitted")
    p.add_argument("--snr_low", type=float, default=5.0)
    p.add_argument("--snr_high", type=float, default=10.0)
    p.add_argument("--blur_low", type=int, default=2)
    p.add_argument("--blur_high", type=int, default=4)
    p.add_argument("--fps", type=float, default=25.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the blur runs: cuda, cuda:N or cpu")
    args = p.parse_args(argv)

    rng = random.Random(args.seed)
    os.makedirs(args.save_root, exist_ok=True)

    noise_pool = []
    if args.noise_root:
        for f in sorted(glob.glob(os.path.join(args.noise_root, "*.wav")))[:64]:
            noise_pool.append(wav_io.read_wav_16k(f))

    files = sorted(glob.glob(os.path.join(args.video_root, "*.mp4")) +
                   glob.glob(os.path.join(args.video_root, "*.avi")))
    print(f"corrupting {len(files)} clips -> {args.save_root}")
    for f in files:
        name = os.path.basename(f)
        out_path = os.path.join(args.save_root, name)
        if os.path.exists(out_path):  # idempotent skip
            continue
        frames = vio.decode_frames(f)
        info = vio.video_info(f)
        wav = (vio.demux_audio_16k(f) if info["has_audio"]
               else np.zeros(16000, np.float32))

        snr = rng.uniform(args.snr_low, args.snr_high)
        if noise_pool:
            pool = noise_pool
        else:
            g = np.random.default_rng(rng.randrange(2 ** 31))
            pool = [g.normal(size=max(len(wav), 16000)).astype(np.float32) * 0.1]
        # [-1,1]-scale floats: SNR math is scale-invariant, skip int16 clip
        noisy, _ = mix_noise(wav, pool, snr, int16_range=False,
                             rng=np.random.default_rng(rng.randrange(2 ** 31)))

        blur = rng.choice([2 ** k for k in range(
            int(np.log2(args.blur_low)), int(np.log2(args.blur_high)) + 1)])
        blurred = blur_frames(frames, blur, device=args.device)

        fps = info["fps"] if info["fps"] > 1 else args.fps
        vio.encode_video(out_path, blurred.astype(np.uint8), fps=fps,
                         audio=noisy.astype(np.float32), audio_sr=16000)
        print(f"  {name}: snr={snr:.1f}dB blur={blur}")
    print("done")


if __name__ == "__main__":
    main()
