"""MLLM inference CLI (``inference_hybird.py`` equivalent) — port of
``mertools_tpu/cli/inference_mllm.py``.

    python -m mertools_tpu_torch.cli.inference_mllm --ckpt=.../model \
        --video_feat_dir=.../clip-vit-large-FRA --audio_feat_dir=.../hubert-FRA \
        --subtitle_csv=transcription.csv --save_path=name2reason.npz \
        --tokenizer=/path/to/llm [--bf16] [--kv_int8] [--device cuda --gpu 0]

Reads per-clip frame/audio features from the feature stores (the offline
extraction pipeline's output), restores the AffectGPT of a
``runner.save_model`` directory (``--ckpt``), and generates an
emotion-reason description per clip in batches on the card
(``mllm.chat.Chat``), where the reference decodes one sample at a time
(``inference_hybird.py:214-254``). Writes ``name2reason.npz`` as the
reference does (``:259-260``) and resumes where an earlier run stopped.
``--run_dir`` sweeps the ``checkpoint_N`` trainable-only overlays of a
training run (``:33-84``), one ``{save_path}_epoch{N}.npz`` each.

Not ported here: the raw-media mode (``--face_dir`` + ``--audio_dir``,
online encoding), which needs ``mllm/encoders.py`` (ROADMAP A9d).
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

import numpy as np


def read_subtitles(path: str | None) -> dict:
    if not path or not os.path.exists(path):
        return {}
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    key = "sentence" if rows and "sentence" in rows[0] else "chinese"
    return {r["name"]: (r.get(key) or "") for r in rows}


def load_feat(d: str, name: str, cap: int) -> np.ndarray:
    """One clip's (T, D) features, at most ``cap`` frames sampled evenly."""
    x = np.load(os.path.join(d, name + ".npy")).astype(np.float32)
    if x.ndim == 1:
        x = x[None]
    if len(x) > cap:
        x = x[np.linspace(0, len(x) - 1, cap).astype(int)]
    return x


def main(argv=None):
    p = argparse.ArgumentParser("inference_mllm")
    p.add_argument("--ckpt", required=True, help="runner.save_model directory")
    p.add_argument("--video_feat_dir", default=None, help="offline feature store")
    p.add_argument("--audio_feat_dir", default=None)
    p.add_argument("--face_dir", default=None,
                   help="per-clip face npy dir, encoded online (not ported: A9d)")
    p.add_argument("--audio_dir", default=None,
                   help="per-clip 16 kHz wav dir, encoded online (not ported: A9d)")
    p.add_argument("--visual_encoder", default="CLIP_VIT_LARGE")
    p.add_argument("--acoustic_encoder", default="HUBERT_LARGE")
    p.add_argument("--visual_pretrain", default=None)
    p.add_argument("--acoustic_pretrain", default=None)
    p.add_argument("--random_init_encoders", action="store_true")
    # multi-stream feature stores (models saved with face_or_frame set);
    # unset streams fall back to --video_feat_dir
    p.add_argument("--face_feat_dir", default=None)
    p.add_argument("--frame_feat_dir", default=None)
    p.add_argument("--image_feat_dir", default=None)
    p.add_argument("--subtitle_csv", default=None)
    p.add_argument("--question", "--outside_user_message", default=None,
                   help="override the default question (reference "
                        "outside_user_message, inference_hybird.py:123)")
    p.add_argument("--save_path", required=True)
    p.add_argument("--tokenizer", required=True, help="the LLM's tokenizer directory")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max_video_frames", type=int, default=64)
    p.add_argument("--max_audio_frames", type=int, default=64)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 LLM decode (the reference's fp16-autocast class)")
    p.add_argument("--kv_int8", action="store_true",
                   help="int8 KV cache for generation (~1e-2 logit class)")
    p.add_argument("--run_dir", default=None,
                   help="training output_dir with checkpoint_N subdirs")
    p.add_argument("--test_epoch", default=None)
    p.add_argument("--test_epochs", default=None, help="'a-b' range")
    p.add_argument("--skip_epoch", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    args = p.parse_args(argv)

    if args.face_dir is not None or args.audio_dir is not None:
        raise SystemExit("raw-media inference (--face_dir / --audio_dir) encodes "
                         "with the frozen visual and acoustic encoders of "
                         "mllm/encoders.py, which are not ported to "
                         "mertools_tpu_torch yet (ROADMAP A9d); extract features "
                         "and pass --video_feat_dir / --audio_feat_dir")
    if not (args.video_feat_dir and args.audio_feat_dir):
        raise SystemExit("feature-store mode needs --video_feat_dir and --audio_feat_dir")

    from concurrent.futures import ThreadPoolExecutor

    from ..core.checkpoint import load_tokenizer
    from ..core.profiling import trace
    from ..mllm.affectgpt import stream_plan
    from ..mllm.chat import Chat
    from ..mllm.runner import epoch_checkpoints, overlay_trainable, restore_model

    device = f"cuda:{args.gpu}" if args.device == "cuda" else "cpu"
    model = restore_model(args.ckpt, device)
    tok = load_tokenizer(args.tokenizer)
    sweep = (epoch_checkpoints(args.run_dir, args.test_epoch, args.test_epochs,
                               args.skip_epoch) if args.run_dir else [(None, None)])

    subtitles = read_subtitles(args.subtitle_csv)
    files = sorted(glob.glob(os.path.join(args.video_feat_dir, "*.npy")))
    names = [os.path.splitext(os.path.basename(f))[0] for f in files]
    streams = None
    if model.cfg.face_or_frame is not None:
        _, streams = stream_plan(model.cfg.face_or_frame)
        stream_dir = {"audio": args.audio_feat_dir,
                      "face": args.face_feat_dir or args.video_feat_dir,
                      "frame": args.frame_feat_dir or args.video_feat_dir,
                      "image": args.image_feat_dir or args.video_feat_dir}

    def feat_keys(n):
        """Per-sample features: the legacy AV pair or per-stream keys."""
        if streams is None:
            return {"video_feats": load_feat(args.video_feat_dir, n, args.max_video_frames),
                    "audio_feats": load_feat(args.audio_feat_dir, n, args.max_audio_frames)}
        return {f"{s}_feats": load_feat(stream_dir[s], n, args.max_audio_frames
                                        if s == "audio" else args.max_video_frames)
                for s in streams}

    def load_group(group):
        """One batch's feature reads (npy reads release the GIL, so they
        overlap the card generating the previous batch)."""
        return [{**feat_keys(n), "subtitle": subtitles.get(n, ""),
                 "question": args.question} for n in group]

    for epoch, ckpt_path in sweep:
        if ckpt_path is not None:
            overlay_trainable(model, ckpt_path)
            base, ext = os.path.splitext(args.save_path)
            save_path = f"{base}_epoch{epoch}{ext or '.npz'}"
            print(f"== epoch {epoch} ({ckpt_path}) -> {save_path}")
        else:
            save_path = args.save_path
        chat = Chat(model, tok, max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature, kv_int8=args.kv_int8,
                    bf16=args.bf16, device=device)

        name2reason = {}
        if os.path.exists(save_path):  # idempotent resume (reference :209)
            old = np.load(save_path, allow_pickle=True)
            if "name2reason" in old:
                name2reason = dict(old["name2reason"].item())
        todo = [n for n in names if n not in name2reason]
        print(f"{len(todo)} clips to process ({len(name2reason)} cached)")

        groups = [todo[i: i + args.batch] for i in range(0, len(todo), args.batch)]
        with trace(), ThreadPoolExecutor(max_workers=1) as pool:
            nxt = pool.submit(load_group, groups[0]) if groups else None
            for gi, group in enumerate(groups):
                samples = nxt.result()
                nxt = (pool.submit(load_group, groups[gi + 1])
                       if gi + 1 < len(groups) else None)
                for n, a in zip(group, chat.answer_batch(samples)):
                    name2reason[n] = a
                np.savez_compressed(save_path, name2reason=name2reason)
                print(f"  {len(name2reason)}/{len(names)} done")
        print(f"wrote {save_path}")


if __name__ == "__main__":
    main()
