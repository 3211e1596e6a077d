"""Open-vocabulary label extraction CLI — port of
``mertools_tpu/cli/ovlabel_extraction.py`` (``ovlabel_extraction.py`` /
``evaluation.py`` vLLM-batch equivalent).

    python -m mertools_tpu_torch.cli.ovlabel_extraction \
        --reason_npz=name2reason.npz --store_npz=name2openset.npz \
        --model=/path/to/qwen-checkpoint [--engine continuous] [--w8] [--bf16] \
        [--device cuda --gpu 0]

The reference batches reason->openset prompts through vLLM
(``MER2025/MER2025_Track23/evaluation.py:16-77``, sampling temperature=0.7,
top_p=0.8, max 512 tokens). Here the same batched extraction runs the port's
LLM on the card: the static engine through ``generate.batch_generate_texts``,
``--engine continuous`` through ``serve.ContinuousBatcher`` with the shared
few-shot template prefilled once. The checkpoint is a local HF causal-LM
directory read by ``core/checkpoint`` (``config.json`` and the weights);
only its tokenizer needs ``transformers``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# reference-exact expert-role few-shot template (reason_to_openset_qwen,
# toolkit/utils/qwen.py:272-281) — same-model extraction quality depends on
# the exact wording and the bracketed-list output examples
EXTRACT_PROMPT = (
    "Please assume the role of an expert in the field of emotions. "
    "We provide clues that may be related to the emotions of the "
    "characters. Based on the provided clues, please identify the "
    "emotional states of the main character. "
    "The main character is the one with the most detailed clues. "
    "Please separate different emotional categories with commas and output "
    "only the clearly identifiable emotional categories in a list format. "
    "If none are identified, please output an empty list. "
    "Input: We cannot recognize his emotional state; Output: [] "
    "Input: His emotional state is happy, sad, and angry; "
    "Output: [happy, sad, angry] "
    "Input: {reason}; Output: ")

_STRIP_PREFIXES = ("输入", "输出", "翻译", "output", "Output", "input",
                   "Input")  # func_postprocess_qwen (qwen.py:15-30)


def postprocess_openset(text: str) -> str:
    """Model output -> normalized 'label1, label2' string (reference
    func_postprocess_qwen prefix stripping, qwen.py:15-30, + the
    string_to_list bracket parsing applied at metric time). The prompt's
    few-shot examples elicit '[happy, sad]'-shaped lists; unbracketed
    replies fall back to first-line comma parsing."""
    import re

    from ..ops.ov_metrics import string_to_list

    text = text.strip()
    for pre in _STRIP_PREFIXES:
        if text.startswith(pre):
            text = text[len(pre):].strip()
    for pre in (":", "："):
        if text.startswith(pre):
            text = text[len(pre):].strip()
    # the answer list is the LAST bracketed group: chatty models echo the
    # few-shot examples or use brackets in a preamble before answering
    matches = re.findall(r"\[[^\]]*\]", text.replace("\n", " "))
    if matches:
        parts = string_to_list(matches[-1])
    else:
        parts = text.split("\n")[0].replace(";", ",").split(",")
    labels = []
    for part in parts:
        w = "".join(ch for ch in str(part).strip().lower()
                    if ch.isalpha() or ch in " -").strip()
        if w and w not in labels:
            labels.append(w)
    return ", ".join(labels)


def encode_prompt(tok, reason: str) -> list:
    """Token ids for one extraction prompt. Chat/instruct models get the
    chat template (the reference applies apply_chat_template before vLLM,
    qwen.py:69-77); plain-LM tokenizers fall back to raw encoding."""
    prompt = EXTRACT_PROMPT.format(reason=str(reason)[:2000])
    if hasattr(tok, "apply_chat_template") and getattr(
            tok, "chat_template", None):
        return tok.apply_chat_template([{"role": "user", "content": prompt}],
                                       tokenize=True,
                                       add_generation_prompt=True)
    return tok.encode(prompt)


def load_name2reason(reason_npz=None, reason_root=None):
    if reason_npz:
        data = np.load(reason_npz, allow_pickle=True)
        if "name2reason" in data:
            return dict(data["name2reason"].item())
        return dict(zip([str(n) for n in data["filenames"]],
                        [str(i) for i in data["fileitems"]]))
    out = {}
    for f in sorted(os.listdir(reason_root)):
        if f.endswith(".npy"):
            out[f[:-4]] = str(np.load(os.path.join(reason_root, f),
                                      allow_pickle=True))
    return out


def load_causal_lm(path: str, device: str = "cuda", gpu: int = 0):
    """(LLM on the device, tokenizer) of the local HF causal-LM directory
    ``path``: ``config.json`` through ``LLMConfig.from_hf``, the weights
    through ``llm.load_hf_state_dict``. ``device`` is the card unless the
    caller asks for ``"cpu"``; a host without a card raises."""
    from ..core.checkpoint import load_tokenizer, read_hf_config, read_hf_weights
    from ..core.device import resolve_device
    from ..mllm.llm import LLM, LLMConfig, load_hf_state_dict

    dev = resolve_device(f"cuda:{gpu}" if device == "cuda" else "cpu", fp32=True)
    model = LLM(LLMConfig.from_hf(read_hf_config(path)), device=dev)
    missing, unexpected = model.load_state_dict(
        load_hf_state_dict(read_hf_weights(path)), strict=False)
    if missing or unexpected:
        raise SystemExit(f"{path}: missing {missing[:5]}, unexpected {unexpected[:5]}")
    return model.eval(), load_tokenizer(path)


def main(argv=None):
    p = argparse.ArgumentParser("ovlabel_extraction")
    p.add_argument("--reason_npz", default=None)
    p.add_argument("--reason_root", default=None)
    p.add_argument("--store_npz", default=None)
    p.add_argument("--store_root", default=None)
    p.add_argument("--model", required=True, help="HF causal-LM checkpoint directory")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top_p", type=float, default=0.8)
    p.add_argument("--repetition_penalty", type=float, default=1.05)
    p.add_argument("--engine", type=str, default="static",
                   choices=["static", "continuous"],
                   help="continuous: slot-based continuous batching "
                        "(honors temperature/top_p/repetition_penalty)")
    p.add_argument("--w8", action="store_true",
                   help="weight-only int8 serving mode (W8Linear)")
    p.add_argument("--kv_int8", action="store_true",
                   help="int8 KV cache (static engine)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 serving mode (the reference's vLLM-fp16 "
                        "class); composes with --w8")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    args = p.parse_args(argv)

    from ..mllm.generate import (batch_generate_texts, cast_llm_bf16,
                                 quantize_llm_w8)

    model, tok = load_causal_lm(args.model, args.device, args.gpu)
    dev = model.norm.weight.device
    if args.w8:
        quantize_llm_w8(model)
    if args.bf16:
        cast_llm_bf16(model)

    name2reason = load_name2reason(args.reason_npz, args.reason_root)
    names = list(name2reason)
    print(f"extracting OV labels for {len(names)} clips")

    if args.engine == "continuous":
        import torch

        from ..mllm.generate import common_token_prefix, prefill_prefix
        from ..mllm.serve import ContinuousBatcher

        ids_by_name = {n: encode_prompt(tok, name2reason[n]) for n in names}
        # the expert few-shot template is shared by every prompt: prefill
        # it once and serve suffixes (vLLM prefix-caching analogue)
        P = common_token_prefix(list(ids_by_name.values()))
        prefix = pre_ids = None
        if P:
            pre_ids = list(ids_by_name[names[0]])[:P]
            prefix = prefill_prefix(
                model, model.embed_tokens.weight[torch.as_tensor(pre_ids, device=dev)].float())
            print(f"shared prefix: {P} tokens prefilled once")
        eng = ContinuousBatcher(model, n_slots=args.batch, max_len=1024,
                                eos_token_id=int(tok.eos_token_id),
                                max_new_tokens=args.max_new_tokens,
                                temperature=args.temperature, top_p=args.top_p,
                                repetition_penalty=args.repetition_penalty,
                                compute_dtype="bf16" if args.bf16 else None,
                                prefix=prefix, prefix_token_ids=pre_ids, device=dev)
        rids = [eng.submit(prompt_ids=ids_by_name[n][P:]) for n in names]
        results = eng.run()
        responses = [postprocess_openset(
            tok.decode(results[r], skip_special_tokens=True)) for r in rids]
        _store(args, names, responses)
        return

    from ..core.profiling import trace

    ids_by_name = {n: encode_prompt(tok, name2reason[n]) for n in names}
    with trace():  # active when MERTPU_TRACE_DIR is set
        texts = batch_generate_texts(
            model, ids_by_name, tok, batch=args.batch,
            max_new_tokens=args.max_new_tokens, temperature=args.temperature,
            top_p=args.top_p, repetition_penalty=args.repetition_penalty,
            kv_int8=args.kv_int8, progress=print, device=dev)

    _store(args, names, [postprocess_openset(texts[n]) for n in names])


def _store(args, names, responses):
    if args.store_root:
        os.makedirs(args.store_root, exist_ok=True)
        for n, r in zip(names, responses):
            np.save(os.path.join(args.store_root, f"{n}.npy"), r)
    if args.store_npz:
        np.savez_compressed(args.store_npz, filenames=names,
                            fileitems=responses)
    print("done")


if __name__ == "__main__":
    main()
