"""Handcrafted acoustic feature CLI — port of
``mertools_tpu/cli/extract_handcrafted.py`` (the reference's
``MERBench/feature_extraction/audio/handcrafted_feature_extractor.py``
runs one openSMILE subprocess or librosa call a wav).

    python -m mertools_tpu_torch.cli.extract_handcrafted --feature_set=IS09 \
        --feature_level=UTTERANCE --audio_dir=.../audio --save_dir=.../features

Whole buckets of clips (edges 2/4/6/8/12/20/30 s, ``--batch`` clips a
batch, as in the JAX CLI, so each clip shares its batch with the same
neighbours) run as one batched computation on ``--device`` (default
``cuda``), fp32 with TF32 off. Sets: ``mel_spec``, ``mfcc``, ``IS09``,
``IS10``, ``IS13``, ``eGeMAPS``. Store layout
as the reference worker's (``handcrafted_feature_extractor.py:50-59``):
``{save_dir}/{set}-{UTT|FRA}/{name}.npy``, UTTERANCE (D,), FRAME (T, D).
A clip whose store file exists is skipped.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

OPENSMILE_SETS = ("IS09", "IS10", "IS13", "eGeMAPS")
LIBROSA_SETS = ("mel_spec", "mfcc")
BUCKET_S = (2, 4, 6, 8, 12, 20, 30)


def _buckets(items, edges):
    out = {e: [] for e in edges}
    for name, wav in items:
        for e in edges:
            if len(wav) <= e:
                out[e].append((name, wav))
                break
        else:
            out[edges[-1]].append((name, wav[: edges[-1]]))
    return out


def extract_batch(names_wavs, feature_set: str, level: str, sr: int,
                  batch: int = 32, device="cuda"):
    """Bucketed batched extraction on ``device``. Returns {name: np.ndarray}:
    UTTERANCE (D,); FRAME the valid frames (the openSMILE sets' mask) or
    ``len // hop + 1`` frames (librosa)."""
    import torch

    from ..core.device import resolve_device, upload
    from ..ops import handcrafted as hc

    dev = resolve_device(device, fp32=True)
    edges = [sr * s for s in BUCKET_S]
    hop = int(0.010 * sr)
    results = {}
    with torch.inference_mode():
        for edge, group in _buckets(names_wavs, edges).items():
            for i in range(0, len(group), batch):
                part = group[i: i + batch]
                wavs = np.zeros((len(part), edge), np.float32)
                lengths = np.zeros(len(part), np.int64)
                for j, (_, w) in enumerate(part):
                    wavs[j, : len(w)] = w
                    lengths[j] = len(w)
                x, n = upload(wavs, dev), upload(lengths, dev)
                if feature_set in OPENSMILE_SETS and level == "UTTERANCE":
                    feats = list(hc.handcrafted_utt(x, n, sr, feature_set).cpu().numpy())
                elif feature_set in OPENSMILE_SETS:
                    f, mask = hc.handcrafted_frame(x, n, sr, feature_set)
                    feats = [r[m] for r, m in zip(f.cpu().numpy(), mask.cpu().numpy())]
                else:   # the librosa sets store their frames at both levels
                    fn = hc.mel_spec_librosa if feature_set == "mel_spec" else hc.mfcc_librosa
                    feats = [r[: max(int(L // hop) + 1, 1)]
                             for r, L in zip(fn(x, sr).cpu().numpy(), lengths)]
                results.update(zip((name for name, _ in part), feats))
    return results


def main(argv=None):
    from ..core.config import resolve_dataset_args
    from ..io import wav as wav_io

    p = argparse.ArgumentParser("extract_handcrafted")
    p.add_argument("--feature_set", type=str, required=True,
                   choices=OPENSMILE_SETS + LIBROSA_SETS)
    p.add_argument("--feature_level", type=str, default="UTTERANCE",
                   choices=["UTTERANCE", "FRAME"])
    p.add_argument("--dataset", type=str, default=None,
                   help="resolve dirs from the path registry (run.sh style)")
    p.add_argument("--audio_dir", type=str, default=None)
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    resolve_dataset_args(args, audio_dir="audio", save_dir="features")

    level_tag = "UTT" if args.feature_level == "UTTERANCE" else "FRA"
    out_dir = os.path.join(args.save_dir, f"{args.feature_set}-{level_tag}")
    os.makedirs(out_dir, exist_ok=True)

    files = sorted(glob.glob(os.path.join(args.audio_dir, "*.wav")))
    print(f"extracting {len(files)} wavs -> {out_dir}")
    t0 = time.time()
    chunk = 512
    done = 0
    for i in range(0, len(files), chunk):
        items = []
        for f in files[i: i + chunk]:
            name = os.path.splitext(os.path.basename(f))[0]
            if os.path.exists(os.path.join(out_dir, name + ".npy")):
                continue
            if args.sr == 16000:
                items.append((name, wav_io.read_wav_16k(f)))
            else:
                w, file_sr = wav_io.read_wav(f)
                items.append((name, wav_io.resample(w, file_sr, args.sr)))
        if not items:
            continue
        feats = extract_batch(items, args.feature_set, args.feature_level,
                              args.sr, args.batch, args.device)
        for name, feat in feats.items():
            np.save(os.path.join(out_dir, name + ".npy"), feat)
        done += len(items)
        print(f"  {done} clips, {done / (time.time() - t0):.2f} clips/sec")
    print(f"Total time used: {time.time() - t0:.1f}s.")


if __name__ == "__main__":
    main()
