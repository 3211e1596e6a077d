"""Visual feature-extraction CLI (``extract_vision_huggingface.py``
equivalent) — port of ``mertools_tpu/cli/extract_vision.py``.

    python -m mertools_tpu_torch.cli.extract_vision --model_name=clip-vit-large-patch14 \
        --face_dir=.../openface_face --save_dir=.../features \
        --feature_level=UTTERANCE --pretrain_dir=/path/to/hf

``face_dir`` holds per-clip ``{name}.npy`` face arrays (T, 112, 112, 3) BGR
uint8 as produced by the OpenFace compression step. The model name picks
the family as the JAX CLI picks it, in its order:

- ``videomae-*``: 16-frame tubelet segments (``--finetuned_ckpt`` too);
- ``dinov2-*`` / ``dino2``: 64 frames, token-summed (``--tome_r``);
- ``data2vec-*`` / ``beit``: token-summed, every frame;
- ``eva-clip-g`` / ``eva_clip_g``: BLIP-2's ``{model_name}.pth`` (or the
  ``.pth`` path itself), ``ln_vision`` token mean (``--tome_r``,
  ``--max_frames``);
- ``siglip-*``: token mean (``--tome_r``, ``--max_frames``);
- anything else, ``eva02-*`` included (the JAX CLI has no EVA-02 branch),
  the CLIP family (``--tome_r``, ``--finetuned_ckpt``).

The CNN families (``emonet``, ``manet``, ``*-ferplus``, ``*-msceleb``,
``*-imagenet``) exit naming ROADMAP A9b2. An HF family reads
``{pretrain_dir}/{model_name}`` (``config.json`` and its weights) without
``transformers``; every extractor runs on ``--device`` (default ``cuda``,
card index ``--gpu``). Output: ``{save_dir}/{model_name}-{UTT|FRA}/{name}.npy``.
``--finetuned_ckpt DIR`` replaces the loaded weights with a fine-tuned
backbone in the same checkpoint layout (``main_release --savemodel``), held
to the architecture's keys and shapes. ``--compute_dtype bf16`` runs
parameters and activations in bfloat16; ``int8`` runs the CLIP family's
transformer products as dynamic w8a8 (``ops/quant.int8_dot_general``) and
the ViT families in fp32, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import glob
import os
import time

import numpy as np

# model-name fragments of the JAX CLI's CNN families: ROADMAP A9b2
_NOT_PORTED = ("emonet", "manet", "ferplus", "msceleb", "imagenet")


def build_extractor(args):
    """The extractor ``args.model_name`` selects; SystemExit for a CNN
    family, not ported yet."""
    from ..core.checkpoint import read_finetuned, read_hf_config, read_hf_weights
    from ..encoders import vit

    name = args.model_name.lower()
    path = (os.path.join(args.pretrain_dir, args.model_name)
            if args.pretrain_dir else args.model_name)
    dev = f"cuda:{args.gpu}" if args.device == "cuda" else "cpu"
    kw = dict(compute_dtype=args.compute_dtype, device=dev)

    def hf_vit(make_cfg):
        cfg = make_cfg(read_hf_config(path))
        return cfg, vit.load_hf_state_dict(cfg, read_hf_weights(path))

    def tome(cfg):   # ToMe production mode (arXiv:2210.09461)
        return dataclasses.replace(cfg, tome_r=args.tome_r) if args.tome_r else cfg

    if "videomae" in name:
        from ..features.vision_zoo import VideoMAEExtractor

        cfg, params = hf_vit(vit.videomae_config)
        if args.finetuned_ckpt:
            params = read_finetuned(args.finetuned_ckpt, params,
                                    functools.partial(vit.load_hf_state_dict, cfg))
        return VideoMAEExtractor(cfg, params, **kw)
    if "dinov2" in name or "dino2" in name:
        from ..features.vision_zoo import vit_token_sum_extractor

        cfg, params = hf_vit(vit.dinov2_config)
        return vit_token_sum_extractor(tome(cfg), params, **kw)
    if "data2vec" in name or "beit" in name:
        from ..features.vision_zoo import vit_token_sum_extractor

        return vit_token_sum_extractor(*hf_vit(vit.beit_config), **kw)
    if "eva-clip-g" in name or "eva_clip_g" in name:
        import torch

        from ..features.vision_zoo import eva_clip_g_token_mean_extractor

        ckpt = path if path.endswith(".pth") else path + ".pth"
        cfg, params = vit.eva_clip_g_from_checkpoint(
            dict(torch.load(ckpt, map_location="cpu", weights_only=True)))
        return eva_clip_g_token_mean_extractor(tome(cfg), params,
                                               max_frames=args.max_frames, **kw)
    if "siglip" in name:
        from ..encoders import siglip
        from ..features.vision_zoo import siglip_token_mean_extractor

        cfg = siglip.SiglipVisionConfig.from_hf(read_hf_config(path))
        return siglip_token_mean_extractor(
            tome(cfg), siglip.load_hf_state_dict(read_hf_weights(path)),
            max_frames=args.max_frames, **kw)
    frag = next((f for f in _NOT_PORTED if f in name), None)
    if frag is not None:
        raise SystemExit(f"{args.model_name}: the {frag} extractor is not "
                         f"ported to mertools_tpu_torch yet (ROADMAP A9b2, the "
                         f"CNN half of the vision zoo); use python -m "
                         f"mertools_tpu.cli.extract_vision")
    # default: the CLIP family
    from ..encoders.vit_clip import CLIPVisionConfig, load_hf_state_dict
    from ..features.vision import VisionExtractor

    cfg = CLIPVisionConfig.from_hf(read_hf_config(path))
    params = load_hf_state_dict(read_hf_weights(path))
    if args.finetuned_ckpt:
        params = read_finetuned(args.finetuned_ckpt, params, load_hf_state_dict)
    return VisionExtractor(tome(cfg), params, max_frames=args.max_frames, **kw)


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
                        "with w8a8 products in CLIP's transformer layers (fp32 "
                        "on the ViT families); default fp32 (TF32 off) for parity")
    p.add_argument("--tome_r", type=int, default=0,
                   help="Token Merging r per layer (CLIP/DINOv2/SigLIP/EVA-CLIP-G "
                        "paths; approximate features)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler Chrome trace to this dir")
    p.add_argument("--finetuned_ckpt", type=str, default=None,
                   help="checkpoint dir of a fine-tuned backbone "
                        "(main_release --savemodel's model/fold{i}_backbone; "
                        "videomae/clip paths)")
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
