"""Transcript translation CLI — port of ``mertools_tpu/cli/translate.py``
(``toolkit/utils/chatgpt.py`` translation helpers, e.g.
``get_translate_eng2chi``/``get_translate_chi2eng``).

    python -m mertools_tpu_torch.cli.translate --trans_path=transcription.csv \
        --save_path=transcription-eng.csv --direction=chi2eng \
        --model=/path/to/qwen-checkpoint [--device cuda --gpu 0]

The reference calls the OpenAI API per sentence with retry loops
(``chatgpt.py:35-46``); here a local LLM translates whole batches through
the KV-cached sampler on the card. Adds the translated column next to the source column
(reference CSVs carry both ``chinese`` and ``english``).
"""

from __future__ import annotations

import argparse
import csv


PROMPTS = {
    "chi2eng": ("Translate the following Chinese sentence into English. "
                "Answer with the translation only.\nChinese: {text}\n"
                "English:"),
    "eng2chi": ("Translate the following English sentence into Chinese. "
                "Answer with the translation only.\nEnglish: {text}\n"
                "Chinese:"),
}
COLS = {"chi2eng": ("chinese", "english"), "eng2chi": ("english", "chinese")}


def main(argv=None):
    p = argparse.ArgumentParser("translate")
    p.add_argument("--trans_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--direction", default="chi2eng", choices=list(PROMPTS))
    p.add_argument("--model", required=True, help="HF causal-LM checkpoint directory")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    args = p.parse_args(argv)

    from ..mllm.generate import batch_generate_texts
    from .ovlabel_extraction import load_causal_lm

    model, tok = load_causal_lm(args.model, args.device, args.gpu)

    src_col, dst_col = COLS[args.direction]
    with open(args.trans_path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    texts = [(r.get(src_col) or "").strip() for r in rows]

    out_texts = [""] * len(rows)
    ids_by_idx = {i: tok.encode(PROMPTS[args.direction].format(
        text=texts[i][:1000])) for i, t in enumerate(texts) if t}
    decoded = batch_generate_texts(
        model, ids_by_idx, tok, batch=args.batch, max_new_tokens=args.max_new_tokens,
        progress=print, device=model.norm.weight.device)
    for i, t in decoded.items():
        out_texts[i] = t.strip()

    fields = list(rows[0].keys()) if rows else ["name", src_col]
    if dst_col not in fields:
        fields.append(dst_col)
    with open(args.save_path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for r, t in zip(rows, out_texts):
            r[dst_col] = t
            w.writerow(r)
    print(f"wrote {len(rows)} rows -> {args.save_path}")


if __name__ == "__main__":
    main()
