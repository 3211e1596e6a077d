"""Visual feature-extraction CLI (``extract_vision_huggingface.py``
equivalent) — port of ``mertools_tpu/cli/extract_vision.py``'s CLIP branch.

    python -m mertools_tpu_torch.cli.extract_vision --model_name=clip-vit-large-patch14 \
        --face_dir=.../openface_face --save_dir=.../features \
        --feature_level=UTTERANCE --pretrain_dir=/path/to/hf

``face_dir`` holds per-clip ``{name}.npy`` face arrays (T, 112, 112, 3) BGR
uint8 as produced by the OpenFace compression step. The CLIP family (the
default, as in the JAX CLI) reads ``{pretrain_dir}/{model_name}``
(``config.json`` of a ``CLIPVisionModelWithProjection`` or a ``CLIPModel``,
and its weights) without ``transformers`` and runs
:class:`..features.vision.VisionExtractor` on ``--device`` (default
``cuda``, card index ``--gpu``). Output:
``{save_dir}/{model_name}-{UTT|FRA}/{name}.npy``. The other families exit
with the ROADMAP item that ports them. ``--finetuned_ckpt DIR`` replaces the
loaded weights with a fine-tuned backbone (``main_release
--model=e2e_model --savemodel``), held to the selected architecture's keys
and shapes; ``--compute_dtype int8`` runs the transformer layers' products
as dynamic w8a8 (``ops/quant.int8_dot_general``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import os
import time

import numpy as np

# model-name fragments of the JAX CLI's other families: ROADMAP A9
_NOT_PORTED = ("videomae", "dinov2", "dino2", "data2vec", "beit", "eva-clip-g",
               "eva_clip_g", "siglip", "emonet", "manet", "ferplus", "msceleb",
               "imagenet")


def build_extractor(args):
    """The CLIP extractor of ``args``; SystemExit for what is not ported."""
    from ..core.checkpoint import read_finetuned, read_hf_config, read_hf_weights
    from ..encoders.vit_clip import CLIPVisionConfig, load_hf_state_dict
    from ..features.vision import VisionExtractor

    name = args.model_name.lower()
    frag = next((f for f in _NOT_PORTED if f in name), None)
    if frag is not None:
        raise SystemExit(f"{args.model_name}: the {frag} extractor is not "
                         f"ported to mertools_tpu_torch yet (ROADMAP A9, the "
                         f"remaining encoder zoo); use python -m "
                         f"mertools_tpu.cli.extract_vision")
    path = (os.path.join(args.pretrain_dir, args.model_name)
            if args.pretrain_dir else args.model_name)
    cfg = CLIPVisionConfig.from_hf(read_hf_config(path))
    if args.tome_r:   # ToMe production mode (CLS contract unchanged)
        cfg = dataclasses.replace(cfg, tome_r=args.tome_r)
    params = load_hf_state_dict(read_hf_weights(path))
    if args.finetuned_ckpt:
        params = read_finetuned(args.finetuned_ckpt, params, load_hf_state_dict)
    return VisionExtractor(
        cfg, params,
        max_frames=args.max_frames, compute_dtype=args.compute_dtype,
        device=f"cuda:{args.gpu}" if args.device == "cuda" else "cpu")


def main(argv=None):
    from ..core.config import resolve_dataset_args

    p = argparse.ArgumentParser("extract_vision")
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--dataset", type=str, default=None,
                   help="resolve dirs from the path registry (run.sh style)")
    p.add_argument("--face_dir", type=str, default=None)
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--feature_level", type=str, default="UTTERANCE",
                   choices=["UTTERANCE", "FRAME"])
    p.add_argument("--pretrain_dir", type=str, default=None)
    p.add_argument("--max_frames", type=int, default=64)
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=[None, "bf16", "int8"],
                   help="bf16: params and activations in bfloat16; int8: bf16 "
                        "with w8a8 products in the transformer layers; default "
                        "fp32 (TF32 off) for parity")
    p.add_argument("--tome_r", type=int, default=0,
                   help="Token Merging r per layer (approximate features)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler Chrome trace to this dir")
    p.add_argument("--finetuned_ckpt", type=str, default=None,
                   help="checkpoint dir of a fine-tuned backbone "
                        "(main_release --savemodel's model/fold{i}_backbone)")
    args = p.parse_args(argv)

    resolve_dataset_args(args, face_dir="openface_face", save_dir="features")
    return _run_extraction(args, build_extractor(args))


def _run_extraction(args, ex):
    """Extract every ``{face_dir}/*.npy`` in chunks of 64 clips and write one
    ``.npy`` a clip; clips that already have a file are skipped."""
    from ..core.profiling import trace

    level = "UTT" if args.feature_level == "UTTERANCE" else "FRA"
    out_dir = os.path.join(args.save_dir, f"{args.model_name}-{level}")
    os.makedirs(out_dir, exist_ok=True)

    files = sorted(glob.glob(os.path.join(args.face_dir, "*.npy")))
    t0 = time.time()
    chunk = 64
    done = 0
    prof = trace(args.profile) if args.profile else contextlib.nullcontext()
    with prof:
        for i in range(0, len(files), chunk):
            faces = {}
            for f in files[i: i + chunk]:
                name = os.path.splitext(os.path.basename(f))[0]
                if os.path.exists(os.path.join(out_dir, name + ".npy")):
                    continue
                faces[name] = np.load(f)
            if not faces:
                continue
            feats = ex.extract(faces, level=level)
            for name, feat in feats.items():
                np.save(os.path.join(out_dir, name + ".npy"), feat)
            done += len(faces)
            print(f"  {done} clips, {done / (time.time() - t0):.2f} clips/sec")
    print(f"Total time used: {time.time() - t0:.1f}s.")


if __name__ == "__main__":
    main()
