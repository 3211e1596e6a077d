"""Continuous-batching LLM serving engine — port of ``mertools_tpu/mllm/serve.py``
(the vLLM-equivalent scheduling the reference uses for OV-label extraction,
``MER2025/MER2025_Track23/evaluation.py:16-21``).

A slot-based engine over the port's :class:`~.llm.LLM`:

- the KV cache is a static (layers, n_slots, kv_heads, max_len, head_dim)
  buffer on the device, written in place;
- decode runs in chunks: every active slot advances ``chunk`` tokens with its
  token, rotary position, physical write index, attendable-KV mask, token
  count and budget held on the device between chunks; the host reads one
  (n_slots, chunk) token matrix a chunk (-1 where a slot generated nothing)
  and no per-token value. The JAX loop exits early on the device once every
  slot is done; a fixed-length chunk gives the same tokens, because inactive
  rows emit -1;
- finished slots free after the chunk that finished them, and waiting
  requests are admitted between chunks, one prefill per (kind, bucket)
  group padded to a power of two. The padding rows are dummies: only the
  group's real rows are scattered into the cache and the per-slot state, so
  they never touch a live slot;
- a shared-prompt prefix (``generate.prefill_prefix``) occupies [0, P) of
  every slot's cache, and prompts are submitted as suffixes.

Greedy at temperature 0; otherwise top-p sampling with the HF repetition
penalty from a ``torch.Generator`` (the reference's SamplingParams). A
generated token's physical cache slot (``write_at``, after the padded
bucket) and its rotary position (``cur_len``, after the valid prompt) are
kept apart, as in :mod:`.generate`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.device import resolve_device, upload
from .generate import _count, _sample, _step, cast_llm_bf16, make_generator, prefill


@dataclass
class _Request:
    rid: int
    tokens: list = field(default_factory=list)
    done: bool = False
    max_new: int = 1 << 30  # per-request token budget (engine default)


class ContinuousBatcher:
    """Continuous-batching engine over the port's LLM module on ``device``
    (the card unless the caller asks for ``"cpu"``; a host without a card
    raises). ``compute_dtype="bf16"`` casts the module to bf16 in place (it
    composes with ``generate.quantize_llm_w8``). ``prefix`` is a
    ``prefill_prefix`` result in the port's layout (layers, kv_heads, P,
    hd)."""

    def __init__(self, model, n_slots: int = 8, max_len: int = 512,
                 eos_token_id: int = 2, max_new_tokens: int = 128,
                 prefill_buckets: tuple = (32, 64, 128, 256),
                 admit_batched: bool = True, temperature: float = 0.0,
                 top_p: float = 0.9, repetition_penalty: float = 1.0,
                 seed: int = 0, chunk: int = 32, compute_dtype: str | None = None,
                 prefix=None, prefix_token_ids=None, device="cuda"):
        if max_new_tokens < 1:
            raise ValueError("ContinuousBatcher needs max_new_tokens >= 1 "
                             "(admission always samples the first token)")
        self.device = dev = resolve_device(device, fp32=compute_dtype != "bf16")
        self.model = model.to(dev)
        if compute_dtype == "bf16":
            cast_llm_bf16(self.model)
        self.dtype = torch.bfloat16 if compute_dtype == "bf16" else torch.float32
        cfg = self.cfg = model.cfg
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.repetition_penalty = float(repetition_penalty)
        self.seen = (torch.zeros(n_slots, cfg.vocab_size, dtype=torch.int32, device=dev)
                     if repetition_penalty != 1.0 else None)
        self.chunk = max(1, int(chunk))
        self.generator = make_generator(dev, seed)
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos = eos_token_id
        self.max_new = max_new_tokens
        self.admit_batched = admit_batched
        self.P = 0
        self.prefix = self.prefix_ids = None
        if prefix is not None:
            self.prefix = tuple(t.to(dev, self.dtype) for t in prefix)
            self.P = self.prefix[0].shape[2]
            if prefix_token_ids is not None:
                self.prefix_ids = torch.as_tensor(np.asarray(prefix_token_ids, np.int64),
                                                  device=dev)
        self.buckets = tuple(b for b in prefill_buckets
                             if self.P + b + max_new_tokens <= max_len) or (
            max_len - max_new_tokens - self.P,)
        if self.buckets[-1] < 1:
            raise ValueError("max_len too small for the prefix + max_new_tokens budget")
        nkv, hd = cfg.num_kv_heads, cfg.hidden_size // cfg.num_heads
        self.k_cache = torch.zeros(cfg.num_layers, n_slots, nkv, max_len, hd,
                                   dtype=self.dtype, device=dev)
        self.v_cache = torch.zeros_like(self.k_cache)
        if self.P:
            self.k_cache[:, :, :, : self.P] = self.prefix[0][:, None]
            self.v_cache[:, :, :, : self.P] = self.prefix[1][:, None]
        # host mirrors of the scheduling state, kept by replaying each
        # chunk's token matrix: which slots decode, and where each writes
        # next (a slot at the cache's end finishes)
        self.write_at = np.zeros(n_slots, np.int64)
        self.active = np.zeros(n_slots, bool)
        z = lambda dtype: torch.zeros(n_slots, dtype=dtype, device=dev)  # noqa: E731
        self._dev = {"next_tok": z(torch.long), "cur_len": z(torch.long),
                     "write_at": z(torch.long), "active": z(torch.bool),
                     "gen_count": z(torch.long),
                     "kv_mask": torch.zeros(n_slots, max_len, dtype=torch.bool, device=dev),
                     "max_new": torch.full((n_slots,), max_new_tokens, dtype=torch.long,
                                           device=dev)}
        self.slot_req: list = [None] * n_slots
        self._next_rid = 0
        self.queue: list = []
        self.finished: dict = {}
        self._pending_admits: list = []

    # -- request admission ---------------------------------------------------
    def submit(self, prompt_embeds: np.ndarray | None = None, prompt_ids=None,
               max_new_tokens: int | None = None) -> int:
        """Queue a request: token ids (``submit(prompt_ids=ids)``, embedded
        on the device; the ids also seed the repetition penalty) or
        embeddings with spliced AV features (``submit(embeds,
        prompt_ids=...)``). ``max_new_tokens`` caps this request's output
        (at most the engine's). Returns the request id."""
        rid = self._next_rid
        self._next_rid += 1
        mn = self.max_new if max_new_tokens is None else int(max_new_tokens)
        if not 1 <= mn <= self.max_new:
            raise ValueError(f"per-request max_new_tokens {mn} outside [1, {self.max_new}]")
        pids = None if prompt_ids is None else np.asarray(prompt_ids, np.int64)
        if prompt_embeds is None:
            if pids is None:
                raise ValueError("submit() needs embeds or prompt_ids")
            self.queue.append((rid, None, pids, mn))
        else:
            self.queue.append((rid, np.asarray(prompt_embeds, np.float32), pids, mn))
        return rid

    def _bucket(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _admit(self):
        free = [s for s in range(self.n_slots) if not self.active[s]]
        if not (free and self.queue):
            return
        pending = []  # (slot, rid, emb|None truncated, ids|None, bucket, mn)
        for slot in free[: min(len(free), len(self.queue))]:
            rid, emb, pids, mn = self.queue.pop(0)
            n = len(emb) if emb is not None else len(pids)
            S = min(n, self.max_len - self.max_new - self.P)
            pad = self._bucket(S)
            S = min(S, pad)  # prompts beyond the largest bucket truncate
            pending.append((slot, rid, None if emb is None else emb[:S],
                            None if pids is None else pids[:S], pad, mn))
        if self.admit_batched:
            for kind, bucket in sorted({(p[2] is None, p[4]) for p in pending}):
                self._admit_group([p for p in pending
                                   if (p[2] is None) == kind and p[4] == bucket], bucket)
        else:
            for p in pending:
                self._admit_group([p], p[4])

    @staticmethod
    def _pow2(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _admit_group(self, grp, bucket):
        """Admit a same-bucket group: prefill (token-id groups embed on the
        device), sample each row's first token, scatter the real rows'
        suffix KV into their slots and update their device state. Only the
        first ``len(grp)`` rows are real; the power-of-two padding rows are
        prefilled and dropped."""
        dev, n = self.device, len(grp)
        H = self.cfg.hidden_size
        B = self._pow2(n) if self.admit_batched else 1
        from_ids = grp[0][2] is None
        P = self.P
        m = np.zeros((B, bucket), np.int64)
        ids = np.zeros((n, bucket), np.int64)
        cmask = np.zeros((n, bucket), np.int64)
        e = None if from_ids else np.zeros((B, bucket, H), np.float32)
        slots = np.zeros(n, np.int64)
        row_len = np.zeros(n, np.int64)
        req_mn = np.zeros(n, np.int64)
        for b, (slot, _, emb, pids, _, mn) in enumerate(grp):
            slots[b], req_mn[b] = slot, mn
            S = len(emb) if emb is not None else len(pids)
            row_len[b] = P + S
            m[b, :S] = 1
            if pids is not None:
                ids[b, : len(pids)] = pids
                cmask[b, : len(pids)] = 1
            if not from_ids:
                e[b, : len(emb)] = emb
        m[n:, 0] = 1   # dummy padding rows (discarded)
        m_t = upload(m, dev)
        if from_ids:
            ids_b = np.zeros((B, bucket), np.int64)
            ids_b[:n] = ids
            emb = self.model.embed_tokens.weight[upload(ids_b, dev)]
            emb = emb * m_t[..., None].to(emb.dtype)
        else:
            emb = upload(e, dev).to(self.dtype)
        logits, k, v, _ = prefill(self.model, emb, m_t, P + bucket, prefix=self.prefix)
        sl = upload(slots, dev)
        ids_t, cmask_t = upload(ids, dev), upload(cmask, dev)
        mn_t = upload(req_mn, dev)
        seen = None
        if self.seen is not None:
            self.seen[sl] = 0
            _count(self.seen, sl[:, None].expand_as(ids_t), ids_t, cmask_t)
            if self.prefix_ids is not None:
                pre = self.prefix_ids[None].expand(n, -1)
                _count(self.seen, sl[:, None].expand_as(pre), pre, torch.ones_like(pre))
            seen = self.seen[sl]
        toks = _sample(logits[:n], self.generator, self.temperature, self.top_p,
                       seen, self.repetition_penalty)
        if self.seen is not None:
            _count(self.seen, sl, toks, torch.ones_like(toks))
        # suffix KV -> the group's slot regions ([0, P) holds the prefix)
        self.k_cache[:, sl, :, P: P + bucket] = k[:, :n, :, P:]
        self.v_cache[:, sl, :, P: P + bucket] = v[:, :n, :, P:]
        d = self._dev
        row_len_t = upload(row_len, dev)
        d["kv_mask"][sl] = torch.arange(self.max_len, device=dev)[None] < row_len_t[:, None]
        d["cur_len"][sl] = row_len_t
        d["write_at"][sl] = P + bucket
        d["next_tok"][sl] = toks
        d["gen_count"][sl] = 1
        d["max_new"][sl] = mn_t
        # a slot whose first token ends it never activates, as on the host
        d["active"][sl] = (toks != self.eos) & (mn_t > 1)
        # the first tokens reach the host after the next chunk is queued
        host = torch.empty(n, dtype=torch.long, pin_memory=dev.type == "cuda")
        host.copy_(toks, non_blocking=True)
        ready = torch.cuda.Event() if dev.type == "cuda" else None
        if ready is not None:
            ready.record()
        for slot, *_ in grp:
            self.write_at[slot] = P + bucket  # physical: prompt pad then gen
            self.active[slot] = True
        self._pending_admits.append((host, ready, list(grp)))

    def _resolve_admits(self):
        """Finish the host bookkeeping of the admissions whose first tokens
        are now on the host (before replaying a chunk's output)."""
        for host, ready, grp in self._pending_admits:
            if ready is not None:
                ready.synchronize()
            first = host.numpy()
            for b, (slot, rid, _, _, _, mn) in enumerate(grp):
                tok = int(first[b])
                # the admission token counts toward max_new
                req = _Request(rid, tokens=[tok], max_new=mn,
                               done=tok == self.eos or mn <= 1)
                self.slot_req[slot] = req
                if req.done:
                    self._finish(slot)
        self._pending_admits = []

    def _finish(self, slot):
        req = self.slot_req[slot]
        toks = req.tokens
        if toks and toks[-1] == self.eos:
            toks = toks[:-1]
        self.finished[req.rid] = toks
        self.active[slot] = False
        self.slot_req[slot] = None

    def _decode_chunk(self) -> torch.Tensor:
        """Advance every active slot ``chunk`` tokens on the device; returns
        the (n_slots, chunk) token matrix, -1 where a slot generated
        nothing. Inactive rows still run (their K/V lands at their own
        unattended write index), as in the JAX loop."""
        d = self._dev
        dev, L = self.device, self.max_len
        rows = torch.arange(self.n_slots, device=dev)
        ar = torch.arange(L, device=dev)
        out = torch.full((self.n_slots, self.chunk), -1, dtype=torch.long, device=dev)
        toks, cur, wat = d["next_tok"], d["cur_len"], d["write_at"]
        mask, act, gcnt = d["kv_mask"], d["active"], d["gen_count"]
        for i in range(self.chunk):
            ai = act.long()
            # this step's token becomes attendable for its own attention
            mask_cur = mask | ((ar[None] == wat[:, None]) & act[:, None])
            logits, _, _ = _step(self.model, toks, cur, wat.clamp(max=L - 1),
                                 self.k_cache, self.v_cache, mask_cur)
            nxt = _sample(logits, self.generator, self.temperature, self.top_p,
                          self.seen, self.repetition_penalty)
            if self.seen is not None:
                _count(self.seen, rows, nxt, ai)
            out[:, i] = torch.where(act, nxt, -1)
            mask = torch.where(act[:, None], mask_cur, mask)
            cur, wat, gcnt = cur + ai, wat + ai, gcnt + ai
            act = act & ~((nxt == self.eos) | (gcnt >= d["max_new"]) | (wat >= L))
            toks = torch.where(act, nxt, toks)
        d.update(next_tok=toks, cur_len=cur, write_at=wat, kv_mask=mask, active=act,
                 gen_count=gcnt)
        return out

    # -- engine loop ---------------------------------------------------------
    @torch.inference_mode()
    def step(self):
        """Admit waiting requests, then decode one chunk for the active
        slots; the host reads the chunk's token matrix once."""
        self._admit()
        if not self.active.any():
            self._resolve_admits()
            return
        out = self._decode_chunk()
        self._resolve_admits()
        outs = out.cpu().numpy()   # the one host read a chunk
        # replay the device loop's control transitions on the host mirrors
        for i in range(outs.shape[1]):
            col = outs[:, i]
            if (col < 0).all():
                break   # every slot was inactive from here on
            for slot in range(self.n_slots):
                tok = int(col[slot])
                if tok < 0 or not self.active[slot]:
                    continue
                self.write_at[slot] += 1
                req = self.slot_req[slot]
                req.tokens.append(tok)
                if (tok == self.eos or len(req.tokens) >= req.max_new
                        or self.write_at[slot] >= self.max_len):
                    self._finish(slot)

    def run(self) -> dict:
        """Drain the queue; returns {rid: [token, ...]} (EOS stripped)."""
        while self.queue or self.active.any():
            self.step()
        out, self.finished = self.finished, {}
        return out
