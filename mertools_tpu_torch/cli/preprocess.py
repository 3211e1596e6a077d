"""Dataset preprocessing / normalization CLI (L2 of the reference) — port of
``mertools_tpu/cli/preprocess.py``, with the same subcommands, flags and
output files.

Subcommands mirror ``toolkit/preprocess/*.py`` + ``main-baseline.py``:

    # video dir -> 16 kHz mono wavs (ffmpeg-subprocess replacement,
    # functions.py:269-277)
    python -m mertools_tpu_torch.cli.preprocess split-audio --video_root=... \
        --save_root=...

    # label CSV (name,emo[,val][,split]) -> label-6way.npz with
    # {split}_corpus dicts (preprocess/mer2023.py:8-53 layout)
    python -m mertools_tpu_torch.cli.preprocess make-labels --label_csv=... \
        --save_path=label-6way.npz

    # per-clip aligned-face frame dirs -> one (T,112,112,3) BGR uint8 npy
    # (OpenFace compression, functions.py "OpenFace compression" /
    # extract_openface.py:14-97 output contract)
    python -m mertools_tpu_torch.cli.preprocess compress-faces --face_root=... \
        --save_root=... [--size=112] [--device cpu]

    # videos or (T, H, W, 3) RGB frame .npy files -> detected, aligned
    # (T, 112, 112, 3) BGR uint8 face stores (the OpenFace replacement)
    python -m mertools_tpu_torch.cli.preprocess detect-faces --video_root=... \
        --save_root=... [--detector_params=blazeface.npz] [--device cpu]

    # integrity checks over a feature store
    # (func_check_feature_completeness, functions.py:297-326)
    python -m mertools_tpu_torch.cli.preprocess check-features --feature_root=... \
        --label_npz=...

The resizes and warps run on ``--device`` (default ``cuda``, the card);
detection and tracking of the Haar route are host code.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

import numpy as np


def cmd_split_audio(args):
    from ..io import video as vio
    from ..io import wav as wav_io

    os.makedirs(args.save_root, exist_ok=True)
    files = sorted(glob.glob(os.path.join(args.video_root, "*.mp4")) +
                   glob.glob(os.path.join(args.video_root, "*.avi")))
    done = 0
    for f in files:
        name = os.path.splitext(os.path.basename(f))[0]
        out = os.path.join(args.save_root, name + ".wav")
        if os.path.exists(out):  # idempotent (functions.py:274)
            continue
        wav = vio.demux_audio_16k(f)
        wav_io.write_wav(out, wav, 16000)
        done += 1
    print(f"split {done}/{len(files)} videos -> {args.save_root}")


def cmd_find_false_audio(args):
    """List videos whose split wav is missing (func_find_false_audio,
    functions.py:280-286) — the audio-split failure scan."""
    files = sorted(glob.glob(os.path.join(args.video_root, "*")))
    missing = []
    for f in files:
        name = os.path.splitext(os.path.basename(f))[0]
        wav = os.path.join(args.audio_root, name + ".wav")
        if not os.path.exists(wav):
            missing.append(wav)
            print(wav)
    print(f"{len(missing)} missing of {len(files)} videos")
    return missing


def cmd_make_labels(args):
    from ..data.labels import write_label_archive

    with open(args.label_csv, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    corpora: dict[str, dict] = {}
    for r in rows:
        split = r.get("split", args.default_split) or args.default_split
        entry = {"emo": r.get("emo", r.get("discrete", ""))}
        val = r.get("val", r.get("valence", ""))
        entry["val"] = float(val) if val not in ("", None) else ""
        corpora.setdefault(split, {})[r["name"]] = entry
    write_label_archive(args.save_path, corpora)
    sizes = {k: len(v) for k, v in corpora.items()}
    print(f"wrote {args.save_path}: {sizes}")


def cmd_compress_faces(args):
    """Each ``{face_root}/{clip}/`` dir of frame images (or a video file) ->
    ``{save_root}/{clip}.npy`` (T, size, size, 3) BGR uint8."""
    from ..core.device import resolve_device
    from ..io import video as vio

    dev = resolve_device(args.device, fp32=True)
    os.makedirs(args.save_root, exist_ok=True)
    clips = sorted(os.listdir(args.face_root))
    done = 0
    for clip in clips:
        src = os.path.join(args.face_root, clip)
        name = os.path.splitext(clip)[0]
        out = os.path.join(args.save_root, name + ".npy")
        if os.path.exists(out):
            continue
        if os.path.isdir(src):
            frames = []
            for img in sorted(glob.glob(os.path.join(src, "*.npy"))):
                frames.append(np.load(img))
            if not frames:
                continue
            arr = np.stack(frames)
        else:
            arr = vio.decode_frames(src)[..., ::-1]  # RGB -> BGR
        if arr.shape[1] != args.size or arr.shape[2] != args.size:
            arr = _resize_frames(arr, args.size, args.size, dev)
        np.save(out, np.clip(arr, 0, 255).astype(np.uint8))
        done += 1
    print(f"compressed {done}/{len(clips)} clips -> {args.save_root}")


def _resize_frames(arr: np.ndarray, out_h: int, out_w: int, dev):
    """(T, H, W, 3) frames, uploaded in their dtype, -> (T, out_h, out_w,
    3) float32 numpy by ``resize_separable("bilinear")``, which equals the
    JAX CLI's ``jax.image.resize(method="bilinear")``."""
    from ..core.device import upload
    from ..ops.image import resize_separable

    x = upload(np.ascontiguousarray(arr), dev).float()
    return resize_separable(x, out_h, out_w, "bilinear").cpu().numpy()


BLAZE_BATCH = 256   # frames a BlazeFace batch: 177 MB of 640 x 360 uint8


def blazeface_align(det, frames: np.ndarray, size: int = 112):
    """The BlazeFace route of ``detect-faces`` on one clip: (T, H, W, 3)
    RGB uint8 frames, uploaded as uint8 to the detector's device in batches
    of ``BLAZE_BATCH`` -> (aligned (T, size, size, 3) RGB float32 crops,
    best-face probabilities (T,)). Each batch is resized to 128 x 128,
    detected and decoded; the best anchor's five landmarks align the full
    frames."""
    import torch

    from ..core.device import upload
    from ..ops.face_align import align_faces
    from ..ops.face_detect import INPUT_SIZE, N_LANDMARKS
    from ..ops.image import resize_separable

    T, H, W = frames.shape[:3]
    wh = torch.tensor([W, H], dtype=torch.float32, device=det.device)
    crops, probs = [], []
    for i in range(0, T, BLAZE_BATCH):
        x = upload(np.ascontiguousarray(frames[i: i + BLAZE_BATCH]), det.device)
        small = resize_separable(x.float() / 255.0, INPUT_SIZE, INPUT_SIZE,
                                 "bilinear")
        dets, p = det.detect_tensor(small)
        lms = dets[:, 4: 4 + 2 * N_LANDMARKS].reshape(-1, N_LANDMARKS, 2) * wh
        crops.append(align_faces(x, lms, out_size=size).cpu().numpy())
        probs.append(p.cpu().numpy())
    return np.concatenate(crops), np.concatenate(probs)


def read_detector_params(path: str) -> dict:
    """The JAX package's BlazeFace parameter npz
    (``np.savez(params=np.array(tree, dtype=object))``) -> the nested Flax
    tree of numpy arrays, read without flax (the JAX CLI's reader)."""
    params = dict(np.load(path, allow_pickle=True))
    if "params" in params:
        params = params["params"].item()
    return params


def cmd_detect_faces(args):
    """Video/frame-npy -> detected+aligned (T, size, size, 3) BGR uint8 face
    stores: the full OpenFace replacement path. Two detector backends:
    the Viola-Jones cascade frontend (default — the cascades ship in the
    package, ops/face_haar; host detection and tracking, the warp on
    ``--device``) or a learned BlazeFace param tree (--detector_params,
    ops/face_detect; all on ``--device``)."""
    from ..io import video as vio

    if args.detector_params is None:
        from ..ops.face_haar import HaarFaceFrontend

        frontend = HaarFaceFrontend(detect_every=args.detect_every,
                                    min_neighbors=args.min_neighbors,
                                    min_size_frac=args.min_size_frac)
        os.makedirs(args.save_root, exist_ok=True)
        for clip in sorted(os.listdir(args.video_root)):
            name = os.path.splitext(clip)[0]
            out = os.path.join(args.save_root, name + ".npy")
            if os.path.exists(out):
                continue
            src = os.path.join(args.video_root, clip)
            frames = (np.load(src) if clip.endswith(".npy")
                      else vio.decode_frames(src))        # (T, H, W, 3) RGB
            aligned, detected = frontend.crop_video(frames, size=args.size,
                                                    device=args.device)
            np.save(out, aligned)
            print(f"  {name}: {int(detected.sum())}/{len(frames)} frames"
                  " with faces")
        print("done")
        return

    from ..ops.face_detect import FaceDetector, from_flax

    det = FaceDetector(from_flax(read_detector_params(args.detector_params)),
                       width=args.detector_width, device=args.device)

    os.makedirs(args.save_root, exist_ok=True)
    clips = sorted(os.listdir(args.video_root))
    for clip in clips:
        name = os.path.splitext(clip)[0]
        out = os.path.join(args.save_root, name + ".npy")
        if os.path.exists(out):
            continue
        src = os.path.join(args.video_root, clip)
        frames = (np.load(src) if clip.endswith(".npy")
                  else vio.decode_frames(src))            # (T, H, W, 3) RGB
        T = len(frames)
        aligned, probs = blazeface_align(det, frames, args.size)
        keep = probs >= args.score_thresh
        aligned = aligned[keep] if keep.any() else aligned[:1] * 0
        np.save(out, np.clip(aligned[..., ::-1], 0, 255).astype(np.uint8))
        print(f"  {name}: {int(keep.sum())}/{T} frames with faces")
    print("done")


def cmd_normalize_dataset(args):
    from ..data import normalize as N

    ds = args.dataset
    if ds in ("cmumosi", "cmumosei"):
        assert args.label_pkl, f"{ds} needs --label_pkl"
        out = N.normalize_cmu(args.label_pkl, args.save_root)
    elif ds == "iemocap":
        assert args.label_pkl, "iemocap needs --label_pkl"
        out = N.normalize_iemocap(args.label_pkl, args.save_root,
                                  data_root=args.data_root, ways=args.ways)
    else:
        assert args.data_root, f"{ds} needs --data_root"
        out = N.NORMALIZERS[ds](args.data_root, args.save_root,
                                copy_videos=args.copy_videos)
    print(f"wrote {out}")
    return out


def cmd_scan_faces(args):
    from ..data import normalize as N

    name2len, short = N.scan_face_store(
        args.face_root, save_path=args.save_path,
        min_frames=args.min_frames, delete_short=args.delete_short)
    lens = list(name2len.values())
    print(f"sample number: {len(name2len)}")
    if lens:
        print(f"min/max/mean len: {min(lens)}/{max(lens)}/"
              f"{sum(lens) / len(lens):.1f}")
    for name in short:
        print(f"<= {args.min_frames} faces: {name}")
    return name2len


def cmd_check_features(args):
    """Completeness scan: every labeled clip has a feature file with finite
    values and a consistent trailing dim."""
    names = set()
    archive = np.load(args.label_npz, allow_pickle=True)
    for key in archive.files:
        names.update(archive[key].tolist().keys())
    missing, bad, dims = [], [], set()
    for name in sorted(names):
        path = os.path.join(args.feature_root, name + ".npy")
        if not os.path.exists(path):
            missing.append(name)
            continue
        feat = np.load(path)
        if not np.isfinite(feat).all() or feat.size == 0:
            bad.append(name)
        dims.add(feat.shape[-1])
    print(f"checked {len(names)}: missing={len(missing)} bad={len(bad)} "
          f"dims={sorted(dims)}")
    if missing[:5]:
        print("  e.g. missing:", missing[:5])
    return {"missing": missing, "bad": bad, "dims": sorted(dims)}


def main(argv=None):
    p = argparse.ArgumentParser("preprocess")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("split-audio")
    s.add_argument("--video_root", required=True)
    s.add_argument("--save_root", required=True)
    s.set_defaults(fn=cmd_split_audio)

    fa = sub.add_parser("find-false-audio",
                        help="list videos whose split wav is missing")
    fa.add_argument("--video_root", required=True)
    fa.add_argument("--audio_root", required=True)
    fa.set_defaults(fn=cmd_find_false_audio)

    m = sub.add_parser("make-labels")
    m.add_argument("--label_csv", required=True)
    m.add_argument("--save_path", required=True)
    m.add_argument("--default_split", default="train")
    m.set_defaults(fn=cmd_make_labels)

    c = sub.add_parser("compress-faces")
    c.add_argument("--face_root", required=True)
    c.add_argument("--save_root", required=True)
    c.add_argument("--size", type=int, default=112)
    c.add_argument("--device", default="cuda",
                   help="where the resize runs (cuda, cuda:N or cpu)")
    c.set_defaults(fn=cmd_compress_faces)

    d = sub.add_parser("detect-faces")
    d.add_argument("--video_root", required=True)
    d.add_argument("--save_root", required=True)
    d.add_argument("--detector_params", default=None,
                   help="npz param tree for ops/face_detect.BlazeFace; "
                        "omit to use the in-tree Viola-Jones cascades")
    d.add_argument("--detector_width", type=int, default=32)
    d.add_argument("--size", type=int, default=112)
    d.add_argument("--score_thresh", type=float, default=0.5)
    d.add_argument("--detect_every", type=int, default=1,
                   help="haar backend: detect every k-th frame, track between")
    d.add_argument("--min_neighbors", type=int, default=3,
                   help="haar backend: rectangle-grouping strictness")
    d.add_argument("--min_size_frac", type=float, default=0.2,
                   help="haar backend: min face size as a fraction of "
                        "min(H, W)")
    d.add_argument("--device", default="cuda",
                   help="where the warp (and BlazeFace) runs: cuda, cuda:N "
                        "or cpu")
    d.set_defaults(fn=cmd_detect_faces)

    n = sub.add_parser("normalize-dataset",
                       help="raw dataset distribution -> normalized layout "
                            "(toolkit/preprocess/* equivalents)")
    n.add_argument("--dataset", required=True,
                   choices=["mer2023", "mer2024", "mer2025", "mer2026",
                            "meld", "sims", "simsv2",
                            "cmumosi", "cmumosei", "iemocap"])
    n.add_argument("--data_root", default=None,
                   help="raw distribution root (CSV layouts)")
    n.add_argument("--label_pkl", default=None,
                   help="community label pkl (cmumosi/cmumosei/iemocap)")
    n.add_argument("--save_root", required=True)
    n.add_argument("--copy_videos", action="store_true")
    n.add_argument("--ways", type=int, default=4, help="iemocap 4/6-way")
    n.set_defaults(fn=cmd_normalize_dataset)

    f = sub.add_parser("scan-faces",
                       help="frame-count scan of an openface_face store; "
                            "flags clips with <= min_frames usable faces "
                            "(mer2023_unlabel.py equivalent)")
    f.add_argument("--face_root", required=True)
    f.add_argument("--save_path", default=None, help="name2len npz out")
    f.add_argument("--min_frames", type=int, default=16)
    f.add_argument("--delete_short", action="store_true")
    f.set_defaults(fn=cmd_scan_faces)

    k = sub.add_parser("check-features")
    k.add_argument("--feature_root", required=True)
    k.add_argument("--label_npz", required=True)
    k.set_defaults(fn=cmd_check_features)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
