"""Batched text feature extraction — port of ``mertools_tpu/features/text.py``
(the BERT family; the decoder-LLM extractor is ROADMAP A9c).

Reference semantics (``extract_text_huggingface.py``): per transcript —
tokenize, forward with every hidden state, sum the last 4 layers, slice away
the special tokens by the decode-round-trip span probe
(``find_start_end_pos:95-120``); FRA = per-token (T, D), UTT = token mean;
empty transcripts give zeros.

As in the JAX package, sentences are tokenized up front, sorted by token
count, padded on the right to a few bucket lengths and forwarded in batches
with attention masks; masked batching equals per-sentence forwards (BERT
masks padded keys, padded rows are thrown away). Every batch is dispatched
before any result is read, and UTT pooling (span trim + token mean) runs on
the device, so only (B, D) crosses back.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device, upload
from ..encoders.bert import BertConfig, BertEncoder


def find_token_span(tokenizer, probe: str = "今天天气真好") -> tuple[int, int | None]:
    """Reference's decode-round-trip special-token span detection
    (find_start_end_pos). Returns (start, end) for python slicing."""
    ids = tokenizer(probe)["input_ids"]
    start = 0
    for start in range(0, 3):
        out = tokenizer.decode(ids[start:]).replace(" ", "")
        if out == probe:
            return start, None
        if out.startswith(probe):
            break
    for end in range(-1, -3, -1):
        if tokenizer.decode(ids[start:end]).replace(" ", "") == probe:
            break
    if tokenizer.decode(ids[start:end]).replace(" ", "") != probe:
        raise ValueError(f"no special-token span of {probe!r} round-trips "
                         f"through the tokenizer")
    return start, end


DEFAULT_TOKEN_BUCKETS = (16, 32, 64, 128, 256, 512)


def _utt_pool(feats: torch.Tensor, mask: torch.Tensor, start: int,
              end0: int) -> torch.Tensor:
    """On-device span trim + token mean: rows average features[start:
    n_valid + end0] (end0 <= 0); an empty span yields zeros (the reference's
    empty-transcript rule, extract_text_huggingface.py:236-249)."""
    n = mask.sum(1)                                  # valid tokens per row
    idx = torch.arange(feats.shape[1], device=feats.device)
    sel = ((idx[None, :] >= start) & (idx[None, :] < (n + end0)[:, None])
           ).to(feats.dtype)
    cnt = sel.sum(1)
    s = torch.einsum("btd,bt->bd", feats, sel)
    return torch.where(cnt[:, None] > 0, s / cnt.clamp_min(1)[:, None], 0.0)


@dataclass
class TextExtractor:
    """Bucketed batched extractor for BERT-family encoders.

    ``params`` is a state dict in this package's (HF) key names."""

    cfg: BertConfig
    params: dict
    layer_ids: tuple = (-4, -3, -2, -1)
    buckets: tuple = DEFAULT_TOKEN_BUCKETS
    batch_size: int = 64
    # None/"f32": fp32 parity mode (TF32 off). "bf16": params and
    # activations in bfloat16, as the JAX package's bf16 mode casts them.
    compute_dtype: str | None = None
    # kernel B1 for the attention; on CPU tensors the same call takes its
    # plain version
    flash: bool = False
    device: object = "cuda"

    def __post_init__(self):
        if self.compute_dtype not in (None, "f32", "bf16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        fast = self.compute_dtype == "bf16"
        self._device = resolve_device(self.device, fp32=not fast)
        self._dtype = torch.bfloat16 if fast else torch.float32
        if self.flash:
            self.cfg = dataclasses.replace(self.cfg, use_flash_attention=True)
        with torch.device("meta"):
            enc = BertEncoder(self.cfg)
        enc.load_state_dict(self.params, strict=True, assign=True)
        self._enc = enc.to(self._device, self._dtype).eval()

    def _features(self, ids, mask):
        hs = self._enc(ids, mask)
        return sum(hs[i] for i in self.layer_ids).float()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @torch.inference_mode()
    def extract(self, token_ids: dict[str, list[int]], span=(1, -1),
                level: str = "FRA") -> dict[str, np.ndarray]:
        """token_ids: name -> tokenizer input_ids (special tokens included).
        span: (start, end) from :func:`find_token_span`."""
        start, end = span
        utt = level.upper().startswith("UTT")
        max_len = self.buckets[-1]
        jobs = sorted(token_ids.items(), key=lambda kv: len(kv[1]))
        D = self.cfg.hidden_size

        pending = []   # dispatch every batch, then collect
        for i in range(0, len(jobs), self.batch_size):
            group = jobs[i: i + self.batch_size]
            bucket = self._bucket(max(len(t) for _, t in group))
            group = [(n, t[:max_len]) for n, t in group]
            ids = np.zeros((len(group), bucket), np.int64)
            mask = np.zeros((len(group), bucket), np.int64)
            for r, (_, toks) in enumerate(group):
                ids[r, : len(toks)] = toks
                mask[r, : len(toks)] = 1
            dev_mask = upload(mask, self._device)
            feats = self._features(upload(ids, self._device), dev_mask)
            pending.append((group, _utt_pool(feats, dev_mask, start, end or 0)
                            if utt else feats))

        out: dict[str, np.ndarray] = {}
        for group, res in pending:
            feats = res.cpu().numpy()
            for r, (name, toks) in enumerate(group):
                if utt:
                    out[name] = feats[r]
                    continue
                emb = feats[r, start: len(toks) + (end or 0)]
                if len(emb) == 0:
                    # empty transcripts -> zeros (reference :236-249)
                    emb = np.zeros((1, D), np.float32)
                out[name] = emb
        return out
