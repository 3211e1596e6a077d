"""ASR transcript CLI (``MER2024/main-asr.py`` equivalent) — port of
``mertools_tpu/cli/main_asr.py``.

    python -m mertools_tpu_torch.cli.main_asr generate --audio_root=.../audio \
        --save_path=transcription.csv --model=/path/to/whisper-checkpoint
    python -m mertools_tpu_torch.cli.main_asr merge --new_path=transcription.csv \
        --check_path=label-transcription.csv --merge_path=merged.csv

Subcommands mirror the reference entry points:
- ``generate``: wav dir -> transcription.csv (name,sentence) — wenet decode
  loop replaced by batched Whisper on ``--device`` (main-asr.py:11-33).
- ``punctuate``: punctuation restoration of an existing CSV
  (paddlespeech TextExecutor replacement, main-asr.py:37-59): with
  ``--model`` (a local HF causal-LM directory) a batched LLM pass on
  ``--device`` whose outputs must keep every word, else rule-based
  segmentation (period append).
- ``merge``: prefer human-checked transcripts (main-asr.py:63-93).
"""

from __future__ import annotations

import argparse
import csv
import glob
import os


def _read_csv_col(path, col):
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return [r.get(col, "") for r in rows], rows


def _write_csv(path, header, rows):
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def cmd_generate(args):
    from ..asr.pipeline import WhisperASR
    from ..core.checkpoint import load_tokenizer, read_hf_config, read_hf_weights
    from ..io import wav as wav_io
    from ..encoders.whisper import WhisperConfig, load_hf_state_dict

    cfg = WhisperConfig.from_config_json(read_hf_config(args.model))
    params = load_hf_state_dict(read_hf_weights(args.model))
    tok = load_tokenizer(args.model)
    device = f"cuda:{args.gpu}" if args.device == "cuda" else "cpu"
    asr = WhisperASR(cfg, params, tokenizer=tok, batch_size=args.batch,
                     prompt=None if args.language is None else tuple(
                         tok.convert_tokens_to_ids(
                             ["<|startoftranscript|>", f"<|{args.language}|>",
                              "<|transcribe|>", "<|notimestamps|>"])),
                     device=device)

    files = sorted(glob.glob(os.path.join(args.audio_root, "*.wav")))
    names = [os.path.splitext(os.path.basename(f))[0] for f in files]
    wavs = [wav_io.read_wav_16k(f) for f in files]
    sentences = asr.transcribe(wavs)
    _write_csv(args.save_path, ["name", "sentence"], zip(names, sentences))
    print(f"wrote {len(names)} transcripts -> {args.save_path}")


PUNCT_PROMPT = (
    "Add punctuation marks to the following transcript. Do not add, remove "
    "or change any words — only insert punctuation. Answer with the "
    "punctuated transcript only.\nTranscript: {text}\nPunctuated:")

_PUNCT_CHARS = set("。，、！？；：.,!?;: \t\"'“”‘’（）()[]【】-—…~·")


def _strip_punct(s: str) -> str:
    return "".join(c for c in s if c not in _PUNCT_CHARS).lower()


def _rule_punctuate(s: str) -> str:
    s = (s or "").strip()
    if s and s[-1] not in "。.!?！？":
        s = s + "。"
    return s


def restore_punctuation(sentences: list[str], decoded: dict) -> tuple[list[str], int]:
    """Merge LLM punctuation outputs with a content-preservation check
    (the reference's paddlespeech TextExecutor never alters the words,
    main-asr.py:37-59 — enforce the same contract on the LLM). Returns
    (refined sentences, #rows where the LLM output was accepted)."""
    out, accepted = [], 0
    for i, s in enumerate(sentences):
        s = (s or "").strip()
        if not s:            # reference keeps NaN rows empty
            out.append("")
            continue
        cand = (decoded.get(i) or "").strip()
        if cand and _strip_punct(cand) == _strip_punct(s):
            out.append(cand)
            accepted += 1
        else:
            out.append(_rule_punctuate(s))
    return out, accepted


def cmd_punctuate(args):
    """Punctuation restoration (reference: paddlespeech TextExecutor per row,
    main-asr.py:37-59). With ``--model``: batched local-LLM restoration
    through ``generate.batch_generate_texts``; outputs that fail the
    content-preservation check fall back to rule-based segmentation.
    Without ``--model``: rule-based only."""
    names, _ = _read_csv_col(args.old_path, "name")
    sents, _ = _read_csv_col(args.old_path, "sentence")
    sents = [(s or "").strip() for s in sents]

    decoded = {}
    if args.model:
        from ..mllm.generate import batch_generate_texts
        from .ovlabel_extraction import load_causal_lm

        model, tok = load_causal_lm(args.model, args.device, args.gpu)
        ids_by_idx = {i: tok.encode(PUNCT_PROMPT.format(text=s[:1000]))
                      for i, s in enumerate(sents) if s}
        decoded = batch_generate_texts(
            model, ids_by_idx, tok, batch=args.batch,
            max_new_tokens=args.max_new_tokens, progress=print,
            device=model.norm.weight.device)

    out, accepted = restore_punctuation(sents, decoded)
    if args.model:
        print(f"LLM punctuation accepted on {accepted}/"
              f"{sum(bool(s) for s in sents)} rows (rest rule-based)")
    _write_csv(args.new_path, ["name", "sentence"], zip(names, out))
    print(f"wrote {len(out)} refined transcripts -> {args.new_path}")


def cmd_merge(args):
    names_new, _ = _read_csv_col(args.new_path, "name")
    sents_new, _ = _read_csv_col(args.new_path, "sentence")
    names_chk, _ = _read_csv_col(args.check_path, "name")
    sents_chk, _ = _read_csv_col(args.check_path, "chinese")
    checked = dict(zip(names_chk, sents_chk))
    merged = [(n, checked.get(n, s)) for n, s in zip(names_new, sents_new)]
    _write_csv(args.merge_path, ["name", "chinese"], merged)
    print(f"merged {len(merged)} transcripts ({sum(n in checked for n in names_new)} checked) -> {args.merge_path}")


def main(argv=None):
    p = argparse.ArgumentParser("main_asr")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate")
    g.add_argument("--audio_root", required=True)
    g.add_argument("--save_path", required=True)
    g.add_argument("--model", required=True,
                   help="HF whisper checkpoint directory")
    g.add_argument("--language", default="zh")
    g.add_argument("--batch", type=int, default=8)
    g.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    g.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    g.set_defaults(fn=cmd_generate)

    r = sub.add_parser("punctuate")
    r.add_argument("--old_path", required=True)
    r.add_argument("--new_path", required=True)
    r.add_argument("--model", default=None,
                   help="HF causal-LM checkpoint directory for the "
                        "punctuation pass (omit for rule-based segmentation only)")
    r.add_argument("--batch", type=int, default=8)
    r.add_argument("--max_new_tokens", type=int, default=192)
    r.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    r.add_argument("--gpu", type=int, default=0, help="CUDA device index")
    r.set_defaults(fn=cmd_punctuate)

    m = sub.add_parser("merge")
    m.add_argument("--new_path", required=True)
    m.add_argument("--check_path", required=True)
    m.add_argument("--merge_path", required=True)
    m.set_defaults(fn=cmd_merge)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
