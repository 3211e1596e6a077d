"""Whisper ASR transcript pipeline — port of ``mertools_tpu/asr/pipeline.py``.

Reference: ``MER2024/main-asr.py:11-33`` runs the wenet C++ decoder per wav
and writes ``transcription.csv`` (columns name,sentence); punctuation
refinement is a second pass (``:37-59``), and human-checked transcripts win
in the merge step (``:63-93``).

Here a batch of B clips runs on the device: 30 s padding -> log-mel
(kernel B2 on a CUDA device, the FFT path on the CPU) -> Whisper encoder ->
KV-cached greedy decode (``asr/decode.py``). Batches have a fixed B; the
last one is filled with zero rows, which are dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device, upload
from ..encoders.whisper import WhisperConfig, build_model
from ..ops.mel import CHUNK_SAMPLES
from ..ops.mel_fused import select_log_mel
from .decode import greedy_decode

# Whisper multilingual special tokens (tokenizer-independent ids for the
# openai vocab family, overridable per checkpoint via the tokenizer).
SOT = 50258
TOK_TRANSCRIBE = 50359
TOK_NOTIMESTAMPS = 50363
LANG_BASE = 50259  # <|en|>; language id = LANG_BASE + lang_index


class WhisperASR:
    """``params`` is a state dict in HF ``WhisperModel`` key names."""

    def __init__(self, cfg: WhisperConfig, params: dict, tokenizer=None,
                 batch_size: int = 8, max_new_tokens: int = 128,
                 prompt: tuple | None = None, device="cuda"):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        if prompt is None:
            if tokenizer is not None:
                prompt = tuple(tokenizer.convert_tokens_to_ids(
                    ["<|startoftranscript|>", "<|zh|>", "<|transcribe|>",
                     "<|notimestamps|>"]))
            else:
                prompt = (SOT, LANG_BASE + 1, TOK_TRANSCRIBE, TOK_NOTIMESTAMPS)
        self.prompt = tuple(int(t) for t in prompt)
        self.device = resolve_device(device, fp32=True)
        self.model = build_model(cfg, params, self.device)
        self.log_mel = select_log_mel(self.device)

    @torch.inference_mode()
    def encode(self, batch: np.ndarray) -> torch.Tensor:
        """(B, 480000) float32 host batch -> (B, 1500, D) encoder output."""
        return self.model.encode(self.log_mel(upload(batch, self.device)))

    def transcribe_batch(self, wavs: list[np.ndarray]) -> list[list[int]]:
        """wavs: list of 16 kHz float32 arrays -> generated token ids."""
        B = self.batch_size
        prompt = torch.tensor([self.prompt] * B, dtype=torch.int32)
        pending = []  # every batch is dispatched before any token is read
        for i in range(0, len(wavs), B):
            group = wavs[i: i + B]
            batch = np.zeros((B, CHUNK_SAMPLES), np.float32)
            for r, w in enumerate(group):
                batch[r, : min(len(w), CHUNK_SAMPLES)] = w[:CHUNK_SAMPLES]
            tokens = greedy_decode(self.cfg, self.model, self.encode(batch),
                                   prompt, len(self.prompt), self.max_new_tokens)
            pending.append((len(group), tokens))
        out: list[list[int]] = []
        for n, tokens in pending:
            tokens = tokens.cpu().numpy()
            for r in range(n):
                toks = tokens[r, len(self.prompt):]
                stop = np.nonzero(toks == self.cfg.eos_token_id)[0]
                out.append(toks[: stop[0]].tolist() if len(stop) else
                           toks.tolist())
        return out

    def transcribe(self, wavs: list[np.ndarray]) -> list[str]:
        token_lists = self.transcribe_batch(wavs)
        if self.tokenizer is None:
            raise ValueError("pass a tokenizer to decode to text")
        return [self.tokenizer.decode(t, skip_special_tokens=True).strip()
                for t in token_lists]
