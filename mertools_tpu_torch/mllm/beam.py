"""HF-semantics beam search and beam sampling — port of
``mertools_tpu/mllm/beam.py``.

Two of the reference's Track3 judge protocols decode with beams: Otter
(``num_beams=3, no_repeat_ngram_size=3, bad_words_ids``, greedy) and SALMONN
(``num_beams=4, do_sample=True, top_p=0.9``). :class:`HFBeam` is the JAX
package's host bookkeeping, a numpy copy kept line for line: it reproduces
transformers' vectorized ``_beam_search`` (2N candidates a step, running
scores ``[0, -1e9, ...]``, hits folded from the top N ranks with the length
penalty, the early-stopping heuristic), and beam *sampling* with the same
``seed`` draws the same beams as the JAX package (``numpy.random.Generator``).

The model forward stays on the device: :func:`beam_generate` prefills once
per prompt, replicates the caches over the beams, and each step reorders the
caches by flat beam index (HF ``reorder_cache``) and decodes one token with
:func:`.generate._step`; only the (B*N, V) logits go to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .generate import _step, prefill

_NEG = np.float32(-1.0e9)


def _log_softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(-1, keepdims=True)
    s = x - m
    return (s - np.log(np.exp(s).sum(-1, keepdims=True))).astype(np.float32)


def _top_p_warp(scores: np.ndarray, top_p: float) -> np.ndarray:
    """HF TopPLogitsWarper (min_tokens_to_keep=1, filter_value=-inf):
    drop the ascending-sorted prefix whose cumulative softmax mass is
    <= 1 - top_p."""
    order = np.argsort(scores, axis=-1, kind="stable")       # ascending
    srt = np.take_along_axis(scores, order, -1)
    e = np.exp(srt - srt.max(-1, keepdims=True))
    cum = np.cumsum(e / e.sum(-1, keepdims=True), -1)
    remove = cum <= (1.0 - top_p)
    remove[..., -1] = False                                   # keep >= 1
    out = scores.copy()
    np.put_along_axis(out, order, np.where(remove, -np.inf,
                                           np.take_along_axis(out, order, -1)
                                           ), -1)
    return out


def _topk_desc(x: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """torch.topk equivalent: values sorted descending, stable over ties."""
    idx = np.argsort(-x, axis=-1, kind="stable")[..., :k]
    return np.take_along_axis(x, idx, -1), idx


class HFBeam:
    """Host-side beam bookkeeping. Drive it with per-step logits of the
    current running beams (flat (B*num_beams, V), beam-major within each
    batch element); it returns the next tokens to feed and the flat beam
    indices the KV caches must be reordered by (HF ``reorder_cache``).

    ``prompts`` (one list of token ids per batch element, may be empty for
    embedding prompts) provide the context ``process_fn(seq, log_probs)``
    sees — HF logits processors receive prompt + generated tokens.
    """

    def __init__(self, batch: int, num_beams: int, vocab_size: int,
                 max_new_tokens: int, eos_token_id: int, *,
                 length_penalty: float = 1.0,
                 early_stopping: bool | str = False,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_p: float = 1.0, min_new_tokens: int = 0,
                 seed: int = 0, prompts: list | None = None,
                 process_fn=None):
        self.B, self.N, self.V = batch, num_beams, vocab_size
        self.T = max_new_tokens
        self.eos = eos_token_id
        self.lp = float(length_penalty)
        self.early = early_stopping
        self.do_sample = do_sample
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.min_new = min_new_tokens
        self.rng = np.random.default_rng(seed)
        self.prompts = ([list(p) for p in prompts] if prompts is not None
                        else [[] for _ in range(batch)])
        self.process_fn = process_fn
        B, N, T = batch, num_beams, max_new_tokens
        self.run_seq = np.zeros((B, N, T), np.int64)
        self.run_scores = np.full((B, N), 0.0, np.float32)
        self.run_scores[:, 1:] = _NEG
        self.fin_seq = np.zeros((B, N, T), np.int64)
        self.fin_len = np.zeros((B, N), np.int32)
        self.fin_scores = np.full((B, N), _NEG, np.float32)
        self.is_fin = np.zeros((B, N), bool)
        self.unsatisfied = np.ones((B, 1), bool)
        self.t = 0
        self.done = False

    def step(self, logits: np.ndarray):
        """logits (B*N, V) for the current running beams -> (next_tokens
        (B*N,) int32, flat beam reorder indices (B*N,) int32, done bool).
        When done is True the returned tokens must NOT be fed back."""
        B, N, V, t = self.B, self.N, self.V, self.t
        lp = _log_softmax(np.asarray(logits, np.float32))
        if t < self.min_new:
            lp[:, self.eos] = -np.inf
        if self.process_fn is not None:
            flat_seq = [self.prompts[r // N]
                        + self.run_seq[r // N, r % N, :t].tolist()
                        for r in range(B * N)]
            for r in range(B * N):
                lp[r] = self.process_fn(flat_seq[r], lp[r])
        if self.do_sample:
            if self.temperature != 1.0:
                lp = lp / np.float32(self.temperature)
            if self.top_p < 1.0:
                lp = _top_p_warp(lp, self.top_p)
        acc = (lp.reshape(B, N, V)
               + self.run_scores[:, :, None]).reshape(B, N * V)

        K = 2 * N                       # beams_to_keep, single EOS token
        if self.do_sample:
            e = np.exp(acc - acc.max(-1, keepdims=True))
            probs = e / e.sum(-1, keepdims=True)
            rows = []
            for b in range(B):
                p = probs[b]
                nz = np.nonzero(p > 0)[0]
                if len(nz) >= K:
                    rows.append(self.rng.choice(N * V, size=K,
                                                replace=False, p=p))
                else:
                    # top-p can collapse the distribution below 2N nonzero
                    # candidates (torch.multinomial would raise here);
                    # degrade to all nonzero + best zero-probability fills
                    head = self.rng.choice(nz, size=len(nz), replace=False,
                                           p=p[nz] / p[nz].sum())
                    zeros = np.argsort(-acc[b], kind="stable")
                    zeros = zeros[~np.isin(zeros, head)][: K - len(nz)]
                    rows.append(np.concatenate([head, zeros]))
            topk_idx = np.stack(rows).astype(np.int64)
            topk_vals = np.take_along_axis(acc, topk_idx, -1)
        else:
            topk_vals, topk_idx = _topk_desc(acc, K)
        src = (topk_idx // V).astype(np.int64)                 # (B, K)
        ids = (topk_idx % V).astype(np.int64)
        cand_seq = np.take_along_axis(
            self.run_seq, src[:, :, None], 1).copy()           # (B, K, T)
        cand_seq[:, :, t] = ids
        hits = (ids == self.eos) | (t + 1 >= self.T)           # (B, K)

        # running beams for the next step (hits excluded)
        run_vals = topk_vals + hits.astype(np.float32) * _NEG
        _, keep = _topk_desc(run_vals, N)
        new_run_seq = np.take_along_axis(cand_seq, keep[:, :, None], 1)
        new_run_scores = np.take_along_axis(run_vals, keep, -1)
        beam_src = np.take_along_axis(src, keep, -1)           # (B, N)

        # fold finished candidates (top-num_beams ranks only) into the
        # finished set, length penalty applied on generated length
        top_mask = np.zeros((K,), bool)
        top_mask[:N] = True
        pen = topk_vals / np.float32((t + 1) ** self.lp)
        eligible = hits & top_mask[None, :]
        pen = pen + (~eligible).astype(np.float32) * _NEG
        pen = pen + (~self.unsatisfied).astype(np.float32) * _NEG
        if self.early is True:
            full = np.all(self.is_fin, axis=1, keepdims=True)
            pen = pen + full.astype(np.float32) * _NEG
        merged_scores = np.concatenate([self.fin_scores, pen], 1)
        merged_seq = np.concatenate([self.fin_seq, cand_seq], 1)
        merged_len = np.concatenate(
            [self.fin_len, np.full((B, K), t + 1, np.int32)], 1)
        merged_fin = np.concatenate([self.is_fin, eligible], 1)
        _, sel = _topk_desc(merged_scores, N)
        self.fin_scores = np.take_along_axis(merged_scores, sel, -1)
        self.fin_seq = np.take_along_axis(merged_seq, sel[:, :, None], 1)
        self.fin_len = np.take_along_axis(merged_len, sel, -1)
        self.is_fin = np.take_along_axis(merged_fin, sel, -1)

        self.t = t + 1
        self.run_seq, self.run_scores = new_run_seq, new_run_scores

        # early-stop heuristic (generation/utils.py _check_early_stop_...)
        if self.early == "never" and self.lp > 0.0:
            hyp_len = self.T
        else:
            hyp_len = self.t
        best_possible = self.run_scores[:, :1] / np.float32(
            hyp_len ** self.lp)
        worst = np.where(self.is_fin,
                         np.min(self.fin_scores, axis=1, keepdims=True),
                         _NEG)
        self.unsatisfied = self.unsatisfied & np.any(
            best_possible > worst, axis=-1, keepdims=True)

        improvement = bool(np.any(self.unsatisfied))
        open_beam = not (bool(np.all(self.is_fin)) and self.early is True)
        continuations = not bool(np.all(hits))
        self.done = not (improvement and open_beam and continuations)

        flat_src = (np.arange(B)[:, None] * N + beam_src).reshape(-1)
        next_tok = new_run_seq[:, :, t].reshape(-1)
        return (next_tok.astype(np.int32), flat_src.astype(np.int32),
                self.done)

    def final(self) -> list[list[int]]:
        """Best finished sequence per batch element (generated tokens only,
        EOS included when the beam ended with one — HF sequences minus the
        prompt)."""
        out = []
        for b in range(self.B):
            n = int(self.fin_len[b, 0])
            out.append(self.fin_seq[b, 0, :n].astype(int).tolist())
        return out


def _reorder(cache, beam_idx):
    if isinstance(cache, tuple):
        return tuple(c.index_select(1, beam_idx) for c in cache)
    return cache.index_select(1, beam_idx)


def _beam_step(model, tok, pos, t: int, k_cache, v_cache, base_mask, beam_idx,
               prompt_len: int):
    """Reorder the caches by flat beam index, then one decode step writing
    slot ``prompt_len + t``."""
    k_cache, v_cache = _reorder(k_cache, beam_idx), _reorder(v_cache, beam_idx)
    slot = prompt_len + t
    ar = torch.arange(base_mask.shape[1], device=base_mask.device)
    slot_mask = base_mask | ((ar >= prompt_len) & (ar <= slot))[None, :]
    return _step(model, tok, pos, slot, k_cache, v_cache, slot_mask)


@torch.inference_mode()
def beam_generate(model, inputs_embeds, attention_mask, *, num_beams: int,
                  max_new_tokens: int, eos_token_id: int,
                  length_penalty: float = 1.0,
                  early_stopping: bool | str = False,
                  do_sample: bool = False, temperature: float = 1.0,
                  top_p: float = 1.0, min_new_tokens: int = 0,
                  seed: int = 0, kv_int8: bool = False,
                  prompt_token_ids=None, process_fn=None) -> list[list[int]]:
    """Beam search / beam sampling over (possibly AV-spliced) prompt
    embeddings on the model's device. Returns one generated-token list per
    batch row (best beam; EOS included when present). ``prompt_token_ids``
    (per-row id lists) give ``process_fn`` its prompt context."""
    dev = model.norm.weight.device
    B, S, _ = inputs_embeds.shape
    N = num_beams
    mask = attention_mask.to(dev)
    logits, k_cache, v_cache, n_valid = prefill(
        model, inputs_embeds, mask, S + max_new_tokens, kv_int8=kv_int8)
    rep = lambda c: c.repeat_interleave(N, dim=1)  # noqa: E731
    k_cache = tuple(map(rep, k_cache)) if kv_int8 else rep(k_cache)
    v_cache = tuple(map(rep, v_cache)) if kv_int8 else rep(v_cache)
    logits = logits.repeat_interleave(N, dim=0)
    n_valid = n_valid.repeat_interleave(N, dim=0)
    base_mask = torch.zeros(B * N, S + max_new_tokens, dtype=torch.bool, device=dev)
    base_mask[:, :S] = mask.repeat_interleave(N, dim=0).bool()
    eng = HFBeam(B, N, model.cfg.vocab_size, max_new_tokens, eos_token_id,
                 length_penalty=length_penalty, early_stopping=early_stopping,
                 do_sample=do_sample, temperature=temperature, top_p=top_p,
                 min_new_tokens=min_new_tokens, seed=seed,
                 prompts=prompt_token_ids, process_fn=process_fn)
    for t in range(max_new_tokens):
        nxt, beam_idx, done = eng.step(logits.cpu().numpy())
        if done:
            break
        logits, k_cache, v_cache = _beam_step(
            model, torch.from_numpy(nxt).long().to(dev), n_valid + t, t,
            k_cache, v_cache, base_mask, torch.from_numpy(beam_idx).long().to(dev), S)
    return eng.final()
