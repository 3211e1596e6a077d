"""AffectGPT-equivalent training CLI — port of
``mertools_tpu/cli/train_mllm.py`` (features mode, one device).

    python -m mertools_tpu_torch.cli.train_mllm --config=train_config.yaml \\
        [--options run.max_epoch=2 model.lora_r=16 ...] [--device cuda --gpu 0]

The YAML sections and keys are the JAX CLI's (model / datasets / run, with
the reference's aliases: ``*_fusion_type``, ``num_*_query_token``,
``face_or_frame`` in either section, ``frozen_*``), plus ``model.
llm_hidden_size`` for the width of the ``tiny`` LLM (4 heads; 256 gives head
dim 64). On a card the LLM attention is kernel B3 whenever the head dim is
one it takes (64 or 128), the eager attention otherwise. Features mode
reads ``.npy`` feature stores through the legacy single-block or the
multi-stream iterator, with the validation split, epoch checkpoints, best
selection and ``run.resume_ckpt_path``.

Not ported here: the mesh flags (``--n_model``, ``--n_seq``, ``--n_pipe`` > 1
exit naming ROADMAP A14) and raw-media mode (``datasets.face_dir`` +
``audio_dir``, which needs the encoder slice A9d).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os


def apply_options(cfg: dict, options: list[str]) -> dict:
    for opt in options or []:
        key, val = opt.split("=", 1)
        parts = key.split(".")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        node[parts[-1]] = val
    return cfg


def _load_llm_checkpoint(ckpt: str, lora_r: int):
    """(LLMConfig, HF-keyed state dict, tokenizer) of an HF causal-LM
    directory, read by the port's checkpoint reader; ``transformers`` only
    for the tokenizer."""
    from ..core.checkpoint import load_tokenizer, read_hf_config, read_hf_weights
    from ..mllm.llm import LLMConfig, load_hf_state_dict

    return (LLMConfig.from_hf(read_hf_config(ckpt), lora_r=lora_r),
            load_hf_state_dict(read_hf_weights(ckpt)), load_tokenizer(ckpt))


def use_b3(device, llm_cfg) -> bool:
    """Whether the LLM attention runs kernel B3: on a CUDA device, at a head
    dim the kernel takes."""
    import torch

    from ..ops.flash_attention_causal import SUPPORTED_HEAD_DIMS

    return (torch.device(device).type == "cuda"
            and llm_cfg.head_dim in SUPPORTED_HEAD_DIMS)


def build_model(mcfg: dict, device="cuda", seed: int = 42):
    """(AffectGPT on ``device``, tokenizer or None) from the model section.
    ``device`` is the card unless the caller asks for ``"cpu"``; a host
    without a card raises rather than falling back to the CPU. Weights are
    drawn from ``seed``; a real ``llm_checkpoint`` replaces the LLM base
    (the LoRA deltas keep their init)."""
    from ..core.device import resolve_device
    from ..mllm.affectgpt import SEGMENTS_BY_MODE, AffectGPTConfig, build
    from ..mllm.llm import LLMConfig
    from ..mllm.qformer import QFormerConfig

    # TF32 stays as the caller set it (main: off unless run.amp is bf16)
    device = resolve_device(device, fp32=False)
    if mcfg.get("llm_checkpoint", "tiny") == "tiny":
        llm_cfg = LLMConfig.tiny(vocab=int(mcfg.get("vocab_size", 256)),
                                 lora_r=int(mcfg.get("lora_r", 4)))
        if mcfg.get("llm_hidden_size"):
            llm_cfg = dataclasses.replace(
                llm_cfg, hidden_size=int(mcfg["llm_hidden_size"]))
        llm_sd = tokenizer = None
    else:
        llm_cfg, llm_sd, tokenizer = _load_llm_checkpoint(
            mcfg["llm_checkpoint"], int(mcfg.get("lora_r", 16)))
    if mcfg.get("remat"):
        llm_cfg = dataclasses.replace(
            llm_cfg, remat=True, remat_policy=str(mcfg.get("remat_policy", "full")))
    if use_b3(device, llm_cfg):
        llm_cfg = dataclasses.replace(llm_cfg, use_flash_attention=True)

    def alias(*keys, default=None):
        return next((mcfg[k] for k in keys if mcfg.get(k) is not None), default)

    face_or_frame = mcfg.get("face_or_frame")
    multi_fusion = alias("multi_fusion_type", "multi_fusion", default="qformer")
    multi = mcfg.get("multi_queries")
    has_multi = multi or (face_or_frame and
                          "multi" in SEGMENTS_BY_MODE[face_or_frame])
    cfg = AffectGPTConfig(
        llm=llm_cfg,
        video_qformer=QFormerConfig(num_queries=int(mcfg.get("video_queries", 32))),
        audio_qformer=QFormerConfig(num_queries=int(mcfg.get("audio_queries", 8))),
        multi_qformer=(QFormerConfig(num_queries=int(multi or 32))
                       if has_multi and multi_fusion == "qformer" else None),
        video_dim=int(mcfg.get("video_dim", 768)),
        audio_dim=int(mcfg.get("audio_dim", 1024)),
        image_dim=int(mcfg["image_dim"]) if mcfg.get("image_dim") else None,
        max_video_frames=int(mcfg.get("max_video_frames", 64)),
        max_audio_frames=int(mcfg.get("max_audio_frames", 64)),
        fusion=mcfg.get("fusion", "qformer"),
        video_fusion=alias("video_fusion_type", "video_fusion"),
        audio_fusion=alias("audio_fusion_type", "audio_fusion"),
        multi_fusion=multi_fusion,
        image_fusion=alias("image_fusion_type", "image_fusion", default="mean"),
        num_video_query_token=int(mcfg.get("num_video_query_token", 1)),
        num_audio_query_token=int(mcfg.get("num_audio_query_token", 1)),
        num_multi_query_token=int(mcfg.get("num_multi_query_token", 1)),
        num_image_query_token=int(mcfg.get("num_image_query_token", 1)),
        face_or_frame=face_or_frame,
        loss_chunk=int(mcfg.get("loss_chunk", 0)))
    model = build(cfg, device, seed)
    if llm_sd is not None:
        missing, unexpected = model.llm.load_state_dict(llm_sd, strict=False)
        if unexpected or any(not k.endswith(("lora_A", "lora_B")) for k in missing):
            raise SystemExit(f"{mcfg['llm_checkpoint']}: unexpected "
                             f"{unexpected[:5]}, missing {missing[:5]}")
    return model, tokenizer


def main(argv=None):
    p = argparse.ArgumentParser("train_mllm")
    p.add_argument("--config", required=True)
    p.add_argument("--options", nargs="*", default=[])
    for flag in ("--n_model", "--n_seq", "--n_pipe"):
        p.add_argument(flag, type=int, default=1,
                       help="mesh width: not ported yet (ROADMAP A14)")
    p.add_argument("--n_micro", type=int, default=0,
                   help="pipeline microbatches (with --n_pipe; not ported)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    args = p.parse_args(argv)
    for flag in ("n_model", "n_seq", "n_pipe"):
        if getattr(args, flag) > 1:
            raise SystemExit(f"--{flag} {getattr(args, flag)}: tensor, sequence "
                             f"and pipeline parallelism are not ported to "
                             f"mertools_tpu_torch yet (ROADMAP A14)")

    import numpy as np

    from ..core.config import load_yaml
    from ..core.device import resolve_device
    from ..mllm.affectgpt import frozen_components
    from ..mllm.data import (CaptionDataset, FakeWordTokenizer,
                             _pad_seq_to_multiple, batch_iterator, build_batch,
                             build_stream_batch, stream_batch_iterator)
    from ..mllm.runner import Runner, RunnerConfig, save_model

    cfg = apply_options(load_yaml(args.config), args.options)
    mcfg, dcfg, rcfg = cfg["model"], cfg["datasets"], cfg.get("run", {})
    if dcfg.get("face_or_frame") and not mcfg.get("face_or_frame"):
        mcfg["face_or_frame"] = dcfg["face_or_frame"]
    if dcfg.get("face_dir") and dcfg.get("audio_dir"):
        raise SystemExit("raw-media training (datasets.face_dir + audio_dir) "
                         "encodes with the frozen visual and acoustic "
                         "encoders, which are not ported to mertools_tpu_torch "
                         "yet (ROADMAP A9d); extract features and train on "
                         "the feature store")

    amp = rcfg.get("amp")
    device = resolve_device(f"cuda:{args.gpu}" if args.device == "cuda" else "cpu",
                            fp32=amp != "bf16")
    seed = int(rcfg.get("seed", 42))
    model, tokenizer = build_model(mcfg, device, seed)
    if tokenizer is None:
        tokenizer = FakeWordTokenizer(model.cfg.llm.vocab_size)

    stream_dirs = {s: dcfg[f"{s}_feat_dir"] for s in ("face", "frame", "audio", "image")
                   if dcfg.get(f"{s}_feat_dir")}
    dataset = CaptionDataset.from_csvs(
        dcfg["openset_csv"], dcfg.get("reason_csv"), dcfg.get("subtitle_csv"),
        dcfg.get("video_feat_dir"), dcfg.get("audio_feat_dir"),
        label_type=dcfg.get("label_type", "description"),
        face_or_frame=model.cfg.face_or_frame, stream_dirs=stream_dirs)
    print(f"dataset: {len(dataset)} annotated clips")

    valid_frac = float(rcfg.get("valid_frac", 0.0))
    val_dataset = None
    if dcfg.get("valid_openset_csv"):
        val_dataset = CaptionDataset.from_csvs(
            dcfg["valid_openset_csv"], dcfg.get("valid_reason_csv"),
            dcfg.get("subtitle_csv"), dcfg.get("video_feat_dir"),
            dcfg.get("audio_feat_dir"),
            label_type=dcfg.get("label_type", "description"),
            face_or_frame=model.cfg.face_or_frame, stream_dirs=stream_dirs)
    elif valid_frac > 0 and len(dataset) >= 4:
        idx = np.random.default_rng(seed).permutation(len(dataset.annotations))
        n_val = max(1, int(len(idx) * valid_frac))
        val_dataset = dataclasses.replace(
            dataset, annotations=[dataset.annotations[i] for i in idx[:n_val]])
        dataset = dataclasses.replace(
            dataset, annotations=[dataset.annotations[i] for i in idx[n_val:]])
        print(f"valid split: {n_val} val / {len(dataset)} train clips")

    frozen = frozen_components(mcfg)
    if frozen:
        print(f"freeze: {', '.join(frozen)}")
    run_cfg = RunnerConfig(
        frozen=frozen,
        max_epoch=int(rcfg.get("max_epoch", 10)),
        iters_per_epoch=int(rcfg.get("iters_per_epoch", 100)),
        batch_size=int(rcfg.get("batch_size", 4)),
        accum_grad_iters=int(rcfg.get("accum_grad_iters", 1)),
        init_lr=float(rcfg.get("init_lr", 1e-4)),
        min_lr=float(rcfg.get("min_lr", 8e-5)),
        warmup_steps=int(rcfg.get("warmup_steps", 100)),
        output_dir=rcfg.get("output_dir", "./mllm_output"),
        compute_dtype="bf16" if amp == "bf16" else None)

    max_len = int(rcfg.get("max_len", 512))
    if model.cfg.face_or_frame is not None:
        it = stream_batch_iterator(dataset, tokenizer, model.cfg,
                                   run_cfg.batch_size, seed=seed, max_len=max_len)
    else:
        it = batch_iterator(dataset, tokenizer, model.num_av_tokens,
                            run_cfg.batch_size, seed=seed, max_len=max_len)
    val_batches = []
    if val_dataset is not None and len(val_dataset) > 0:
        vrng = np.random.default_rng(0)
        vbs = run_cfg.batch_size
        spans = [list(range(i, min(i + vbs, len(val_dataset))))
                 for i in range(0, len(val_dataset), vbs)]
        if len(spans) > 1 and len(spans[-1]) < vbs:
            spans = spans[:-1]  # full batches only, as the JAX CLI
        for span in spans:
            samples = [val_dataset.sample(j, vrng) for j in span]
            if model.cfg.face_or_frame is not None:
                b = build_stream_batch(samples, tokenizer, model.cfg, max_len)
            else:
                b = build_batch(samples, tokenizer, model.num_av_tokens, max_len)
            val_batches.append(_pad_seq_to_multiple(b, 32, max_len))

    runner = Runner(run_cfg, model)
    os.makedirs(run_cfg.output_dir, exist_ok=True)
    start_epoch = 0
    resume = rcfg.get("resume_ckpt_path")
    if resume:
        loaded_epoch = runner.load_checkpoint(resume)
        start_epoch = int(loaded_epoch or 0) + 1
        print(f"resumed from {resume} (epoch {loaded_epoch})")

    best = float("inf")
    for epoch in range(start_epoch, run_cfg.max_epoch):
        stats = runner.train_epoch(epoch, it)
        if val_batches:
            stats["val_loss"] = runner.evaluate(val_batches)
        print(f"epoch {epoch}: {stats}")
        runner.save_checkpoint(epoch)
        crit = stats.get("val_loss", stats["train_loss"])
        if crit < best:
            best = crit
            runner.save_checkpoint(epoch, is_best=True)
    save_model(os.path.join(run_cfg.output_dir, "model"), model)
    print(f"done; best {'val' if val_batches else 'train'} loss {best:.4f}; "
          f"model saved to {run_cfg.output_dir}/model")


if __name__ == "__main__":
    main()
