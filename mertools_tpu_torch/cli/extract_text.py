"""Text feature-extraction CLI (``extract_text_huggingface.py`` equivalent)
— port of ``mertools_tpu/cli/extract_text.py``'s BERT branch.

    python -m mertools_tpu_torch.cli.extract_text --model_name=chinese-macbert-large \
        --trans_path=.../transcription.csv --save_dir=.../features \
        --feature_level=UTTERANCE --language=chinese --pretrain_dir=/path/to/hf

Reads the HF checkpoint ``{pretrain_dir}/{model_name}`` (``config.json`` and
its weights, without ``transformers``; the tokenizer through
``transformers``) and runs :class:`..features.text.TextExtractor` on
``--device`` (default ``cuda``, card index ``--gpu``). CSV columns follow
the reference: ``name`` + ``chinese``/``english``. Output:
``{save_dir}/{model_name}-{UTT|FRA}/{name}.npy``; empty transcripts get
zeros. The BERT family is ported (bert, roberta, xlm-roberta, camembert,
electra); the other branches exit with the ROADMAP item that ports them.
``--finetuned_ckpt DIR`` replaces the loaded weights with a fine-tuned
backbone (``main_release --model=e2e_model --savemodel``), held to the
selected architecture's keys and shapes.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import os
import time

import numpy as np

# decoder-only LMs: the JAX package's CausalLMTextExtractor branch
_LLM_TYPES = ("llama", "qwen2", "mistral", "baichuan")


def _not_ported(model_type: str) -> str | None:
    """The ROADMAP item that ports ``model_type``'s branch, None for the
    BERT family."""
    from ..encoders.bert import BERT_MODEL_TYPES

    if model_type in _LLM_TYPES:
        return ("A9, the decoder-LLM text branch (CausalLMTextExtractor; it "
                "needs output_hidden_states in mllm/llm.py)")
    if model_type not in BERT_MODEL_TYPES:   # chatglm and the text zoo
        return "A9, the text encoder zoo (encoders/text_zoo.py)"
    return None


def main(argv=None):
    from ..core.checkpoint import (load_tokenizer, read_finetuned, read_hf_config,
                                   read_hf_weights)
    from ..core.config import resolve_dataset_args
    from ..encoders.bert import BertConfig, load_hf_state_dict
    from ..features.text import TextExtractor

    p = argparse.ArgumentParser("extract_text")
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--dataset", type=str, default=None,
                   help="resolve dirs from the path registry (run.sh style)")
    p.add_argument("--trans_path", type=str, default=None)
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--feature_level", type=str, default="UTTERANCE",
                   choices=["UTTERANCE", "FRAME"])
    p.add_argument("--language", type=str, default="chinese")
    p.add_argument("--pretrain_dir", type=str, default=None)
    p.add_argument("--layer_ids", type=str, default="-4,-3,-2,-1")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=[None, "bf16"],
                   help="bf16: params and activations in bfloat16; default "
                        "fp32 (TF32 off) for parity")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler Chrome trace to this dir")
    p.add_argument("--finetuned_ckpt", type=str, default=None,
                   help="checkpoint dir of a fine-tuned backbone "
                        "(main_release --savemodel's model/fold{i}_backbone)")
    args = p.parse_args(argv)

    resolve_dataset_args(args, trans_path="transcriptions", save_dir="features")

    path = (os.path.join(args.pretrain_dir, args.model_name)
            if args.pretrain_dir else args.model_name)
    hf_cfg = read_hf_config(path)
    model_type = hf_cfg.get("model_type")
    item = _not_ported(model_type)
    if item is not None:
        raise SystemExit(f"{args.model_name} (model_type {model_type!r}): this "
                         f"text extractor is not ported to mertools_tpu_torch "
                         f"yet (ROADMAP {item}); use python -m "
                         f"mertools_tpu.cli.extract_text")
    cfg = BertConfig.from_hf(hf_cfg)
    params = load_hf_state_dict(read_hf_weights(path))
    if args.finetuned_ckpt:
        params = read_finetuned(args.finetuned_ckpt, params, load_hf_state_dict)
    ex = TextExtractor(cfg, params,
                       layer_ids=tuple(int(x) for x in args.layer_ids.split(",")),
                       compute_dtype=args.compute_dtype,
                       device=f"cuda:{args.gpu}" if args.device == "cuda" else "cpu")
    return _run_extraction(args, load_tokenizer(path), ex, cfg)


def _run_extraction(args, tokenizer, ex, cfg):
    """Tokenize ``args.trans_path``'s ``args.language`` column, extract and
    write one ``.npy`` a clip (zeros for empty transcripts); clips that
    already have a file are skipped."""
    from ..core.profiling import trace
    from ..features.text import find_token_span

    span = find_token_span(tokenizer)

    level = "UTT" if args.feature_level == "UTTERANCE" else "FRA"
    out_dir = os.path.join(args.save_dir, f"{args.model_name}-{level}")
    os.makedirs(out_dir, exist_ok=True)

    with open(args.trans_path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    token_ids, empty = {}, []
    for row in rows:
        name = row["name"]
        if os.path.exists(os.path.join(out_dir, name + ".npy")):
            continue
        sentence = row.get(args.language) or ""
        if not sentence.strip():
            empty.append(name)
        else:
            token_ids[name] = tokenizer(sentence)["input_ids"]

    t0 = time.time()
    with trace(args.profile) if args.profile else contextlib.nullcontext():
        feats = ex.extract(token_ids, span=span, level=level)
    D = cfg.hidden_size
    for name in empty:  # reference: zeros for empty transcripts
        feats[name] = (np.zeros(D, np.float32) if level == "UTT"
                       else np.zeros((1, D), np.float32))
    for name, feat in feats.items():
        np.save(os.path.join(out_dir, name + ".npy"), feat)
    print(f"{len(feats)} clips in {time.time() - t0:.1f}s -> {out_dir}")


if __name__ == "__main__":
    main()
