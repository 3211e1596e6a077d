"""KV-cached autoregressive generation for the port's LLM — port of
``mertools_tpu/mllm/generate.py``.

Functions over the port's :class:`~.llm.LLM` module (its ``LoRALinear`` and
``RMSNorm`` weights), not a second parameter tree. :func:`prefill` runs the
right-padded prompt (token or spliced AV embeddings) in one forward and
writes per-layer K/V into preallocated caches; :func:`generate` then decodes
step by step, writing each step's K/V in place: greedy at temperature 0,
top-k/top-p sampling from an explicit ``torch.Generator`` otherwise. Pad
slots are masked out of attention and rotary positions count only valid
tokens, so ragged prompts batch together.

Two indices of the cache differ and are kept apart: a generated token is
written at the physical slot ``P + S + t`` (after the *padded* prompt), but
its rotary position is ``n_valid + t`` (the *valid* count).

The cache layout is ``(layers, B, kv_heads, L, head_dim)`` (the JAX package
keeps ``(layers, B, L, kv_heads, head_dim)``), so a decode step's grouped
query product reads each layer's cache as it lies, without a transpose. With
``kv_int8`` a cache is ``(int8 codes, fp32 scale (..., 1))``, one scale per
token and head (:func:`_quant_kv`).

The bf16 serving math is the JAX module's, not the training LLM's: rotary
casts cos/sin to the activation dtype before the product, RMSNorm multiplies
in fp32, casts, then scales, and attention logits are promoted to fp32 before
the 1/sqrt(d) scale. ``cast_llm_bf16`` casts the module;
``quantize_llm_w8`` swaps the seven projections and the lm_head for
:class:`W8Linear` (int8 codes, an fp32 per-column scale, the LoRA delta
kept). Everything here is plain PyTorch: the JAX serving path reaches no
Pallas kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import quantize_weight_w8, w8_linear
from .llm import _rope_tables

_W8_KERNELS = ("q_proj", "k_proj", "v_proj", "o_proj",
               "gate_proj", "up_proj", "down_proj")
_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")


class W8Linear(nn.Module):
    """Weight-only int8 linear: ``q`` int8 (out, in) and ``scale`` fp32
    (out,), with the bias and the LoRA delta of the layer it replaces kept in
    full precision. ``Module.to(dtype)`` casts the floats and leaves the
    codes int8, as the JAX bf16 cast does."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bias=None,
                 lora_A=None, lora_B=None, lora_scale: float = 0.0):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        frozen = lambda t: None if t is None else nn.Parameter(t, requires_grad=False)  # noqa: E731
        self.bias = frozen(bias)
        self.lora_A, self.lora_B = frozen(lora_A), frozen(lora_B)
        self.lora_scale = lora_scale

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Module) -> "W8Linear":
        q, s = quantize_weight_w8(lin.weight.detach())
        bias = None if lin.bias is None else lin.bias.detach().clone()
        if getattr(lin, "lora_r", 0):
            return cls(q, s, bias, lin.lora_A.detach().clone(),
                       lin.lora_B.detach().clone(), lin.scale)
        return cls(q, s, bias)

    def dequantized(self) -> torch.Tensor:
        """The weight the codes stand for, ``q * scale`` (fp32)."""
        return self.q.float() * self.scale.float()[:, None]

    def forward(self, x):
        y = w8_linear(x, self.q, self.scale)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if self.lora_A is not None:
            y = y + self.lora_scale * F.linear(F.linear(x, self.lora_A.to(x.dtype)),
                                               self.lora_B.to(x.dtype))
        return y


def cast_llm_bf16(model: nn.Module) -> nn.Module:
    """The production serving cast, in place: floating parameters and
    buffers to bf16 (w8 codes stay int8, so it composes with
    :func:`quantize_llm_w8`). The reference serves fp16, so bf16 is its
    numeric class."""
    return model.to(torch.bfloat16)


@torch.no_grad()
def quantize_llm_w8(model: nn.Module, lm_head: bool = True) -> nn.Module:
    """Swap the seven projections of every layer (``_W8_KERNELS``) and the
    lm_head for :class:`W8Linear`, in place. Norms, biases, embeddings and
    LoRA deltas stay in full precision."""
    for layer in model.layers:
        for name in _W8_KERNELS:
            parent = layer.self_attn if name in _ATTN else layer.mlp
            setattr(parent, name, W8Linear.from_linear(getattr(parent, name)))
    if lm_head:
        model.lm_head = W8Linear.from_linear(model.lm_head)
    return model


def w8_state_dict_from_flax(cfg, params) -> dict:
    """A JAX ``quantize_llm_params_w8`` tree (packed kernels are ``{"q",
    "scale"}`` dicts, numpy-convertible) -> the state dict of a model that
    went through :func:`quantize_llm_w8`: codes transposed to (out, in)."""
    from .llm import state_dict_from_flax

    packed = {}

    def unpack(path, sub):
        if isinstance(sub.get("kernel"), dict):
            packed[path] = sub["kernel"]
            return {**sub, "kernel": np.asarray(sub["kernel"]["q"], np.float32)}
        return sub

    tree = {}
    for name, sub in params.items():
        if name.startswith("layer_"):
            tree[name] = {pn: unpack((name, pn), pp) for pn, pp in sub.items()}
        else:
            tree[name] = unpack((name,), sub)
    sd = state_dict_from_flax(cfg, tree)
    for path, pk in packed.items():
        if path == ("lm_head",):
            key = "lm_head"
        else:
            i, pn = int(path[0].split("_")[1]), path[1]
            key = f"layers.{i}.{'self_attn' if pn in _ATTN else 'mlp'}.{pn}"
        del sd[f"{key}.weight"]
        sd[f"{key}.q"] = torch.from_numpy(np.ascontiguousarray(np.asarray(pk["q"]).T))
        sd[f"{key}.scale"] = torch.from_numpy(np.array(pk["scale"], np.float32))
    return sd


def _quant_kv(t: torch.Tensor):
    """Per-token-per-head symmetric int8: t (..., d) -> (int8 codes, fp32
    scale (..., 1)) with t ~= codes * scale."""
    s = t.float().abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(t.float() / s).to(torch.int8), s


def _rope(positions, hd: int, theta, mrope_section, dtype):
    """cos and sin (B, S, 1, hd/2) for positions (B, S), or (B, S, 3) M-RoPE
    t/h/w ids, computed in fp32 and cast to the activation dtype (bf16
    stays bf16). One pair serves q and k of every layer."""
    inv_freq, comp = _rope_tables(hd, float(theta), mrope_section, positions.device)
    if comp is not None and positions.dim() == 3:
        ang = positions[..., comp].float() * inv_freq
    else:
        ang = positions[..., None].float() * inv_freq
    return torch.cos(ang).to(dtype)[:, :, None, :], torch.sin(ang).to(dtype)[:, :, None, :]


def _rotary(x, rope):
    """HF half rotation of x (B, S, N, hd) by :func:`_rope`'s (cos, sin), in
    x's dtype."""
    cos, sin = rope
    hd = x.shape[-1]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _qkv(cfg, attn, xn):
    B, S, _ = xn.shape
    hd = cfg.hidden_size // cfg.num_heads
    return (attn.q_proj(xn).view(B, S, cfg.num_heads, hd),
            attn.k_proj(xn).view(B, S, cfg.num_kv_heads, hd),
            attn.v_proj(xn).view(B, S, cfg.num_kv_heads, hd))


def _finish_layer(layer, x, att):
    x = x + layer.self_attn.o_proj(att)
    return x + layer.mlp(layer.post_attention_layernorm(x))


def _cache_dtype(model) -> torch.dtype:
    return model.norm.weight.dtype


@torch.inference_mode()
def prefill(model, inputs_embeds, attention_mask, cache_len: int,
            kv_int8: bool = False, positions=None, prefix=None):
    """One forward over the (right-padded) prompt, capturing KV caches.

    Returns (last_logits (B, V) fp32, k_cache, v_cache (layers, B, kv_heads,
    cache_len, hd), n_valid (B,)). ``positions`` overrides the cumsum default
    ((B, S, 3) for M-RoPE models). ``prefix``: ``(k_pre, v_pre)`` of shape
    (layers, kv_heads, P, hd) from :func:`prefill_prefix`, the shared prompt
    prefix: the forward runs only the suffix rows against [prefix; suffix]
    keys, and the caches hold the prefix at [0, P)."""
    cfg = model.cfg
    dev = model.norm.weight.device
    B, S, H = inputs_embeds.shape
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    hd = H // nh
    mask = attention_mask.to(dev).long()
    P = 0
    if prefix is not None:
        if positions is not None or cfg.mrope_section is not None:
            raise ValueError("shared-prefix prefill supports standard-RoPE "
                             "text prompts only")
        P = prefix[0].shape[2]
    if positions is None:
        positions = (mask.cumsum(1) - 1).clamp(min=0) + P
    positions = positions.to(dev)
    n_suffix = mask.sum(1)

    ar = torch.arange(S, device=dev)
    bias = torch.where((ar[:, None] >= ar[None, :])[None, None]
                       & (mask[:, None, None, :] > 0), 0.0, -1e30)
    if P:   # every suffix query attends the whole prefix
        bias = F.pad(bias, (P, 0))

    x = inputs_embeds.to(dev)
    if _cache_dtype(model) == torch.bfloat16:
        x = x.to(torch.bfloat16)
    L = cache_len
    k_cache = torch.zeros(cfg.num_layers, B, nkv, L, hd, dtype=x.dtype, device=dev)
    v_cache = torch.zeros_like(k_cache)
    if P:
        k_cache[:, :, :, :P] = prefix[0].to(x.dtype)[:, None]
        v_cache[:, :, :, :P] = prefix[1].to(x.dtype)[:, None]
    rope = _rope(positions, hd, cfg.rope_theta, cfg.mrope_section, x.dtype)
    for i, layer in enumerate(model.layers):
        q, k, v = _qkv(cfg, layer.self_attn, layer.input_layernorm(x))
        q, k = _rotary(q, rope), _rotary(k, rope)
        k_cache[i, :, :, P: P + S] = k.transpose(1, 2)
        v_cache[i, :, :, P: P + S] = v.transpose(1, 2)
        kf = k_cache[i, :, :, : P + S]            # (B, nkv, P + S, hd)
        vf = v_cache[i, :, :, : P + S]
        if nkv != nh:
            kf = kf.repeat_interleave(nh // nkv, dim=1)
            vf = vf.repeat_interleave(nh // nkv, dim=1)
        logits = torch.matmul(q.transpose(1, 2), kf.transpose(-1, -2)).float() \
            / math.sqrt(hd)
        w = torch.softmax(logits + bias, -1).to(x.dtype)
        att = torch.matmul(w, vf).transpose(1, 2).reshape(B, S, H)
        x = _finish_layer(layer, x, att)

    x = model.norm(x)
    last = x[torch.arange(B, device=dev), n_suffix - 1]
    logits = model.lm_head(last).float()
    n_valid = P + n_suffix
    if kv_int8:
        kq, ksc = _quant_kv(k_cache)
        vq, vsc = _quant_kv(v_cache)
        # pad slots hold zero codes and zero scales, as the JAX pad does
        ksc[:, :, :, P + S:] = 0
        vsc[:, :, :, P + S:] = 0
        return logits, (kq, ksc), (vq, vsc), n_valid
    return logits, k_cache, v_cache, n_valid


def prefill_prefix(model, prefix_embeds) -> tuple:
    """The KV of a shared prompt prefix, computed once: prefix_embeds (P, H)
    -> (k_pre, v_pre) of shape (layers, kv_heads, P, hd), for
    ``prefill(prefix=...)`` and ``generate(prefix=...)``. The prefix must be
    the same in every prompt of a batch (tokens and positions 0..P-1)."""
    P = prefix_embeds.shape[0]
    dev = model.norm.weight.device
    _, k, v, _ = prefill(model, prefix_embeds[None],
                         torch.ones(1, P, dtype=torch.long, device=dev), P)
    return k[:, 0], v[:, 0]


def _write(cache, i, rows, slot, t):
    """cache[i, b, :, slot_b] = t[b] (t (B, kv_heads, d)); ``slot`` is one
    index for every row or a (B,) tensor."""
    if isinstance(slot, int):
        cache[i, :, :, slot] = t
    else:
        cache[i, rows, :, slot] = t


def _step(model, tok, pos, slot, k_cache, v_cache, kv_mask):
    """One decode step, caches written in place. tok (B,); pos (B,) rotary
    positions ((B, 3) with M-RoPE); slot: the physical cache index, an int
    or a (B,) tensor of in-range indices; kv_mask (B, L) bool attendable
    slots. Returns the next logits (B, V) fp32 and the caches."""
    cfg = model.cfg
    B = tok.shape[0]
    H = cfg.hidden_size
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    hd, g = H // nh, nh // nkv
    rows = torch.arange(B, device=tok.device)
    x = model.embed_tokens.weight[tok][:, None]      # (B, 1, H)
    rope = _rope(pos[:, None], hd, cfg.rope_theta, cfg.mrope_section, x.dtype)
    quant = isinstance(k_cache, tuple)
    keep = kv_mask[:, None, None, :]
    for i, layer in enumerate(model.layers):
        q, k, v = _qkv(cfg, layer.self_attn, layer.input_layernorm(x))
        q, k, v = _rotary(q, rope)[:, 0], _rotary(k, rope)[:, 0], v[:, 0]
        if quant:
            (kq_c, ks_c), (vq_c, vs_c) = k_cache, v_cache
            for cache, part in zip((kq_c, ks_c, vq_c, vs_c),
                                   (*_quant_kv(k), *_quant_kv(v))):
                _write(cache, i, rows, slot, part)
            kk, vv = kq_c[i].to(x.dtype), vq_c[i].to(x.dtype)   # (B, nkv, L, hd)
        else:
            _write(k_cache, i, rows, slot, k)
            _write(v_cache, i, rows, slot, v)
            kk, vv = k_cache[i], v_cache[i]
        # grouped queries against the unrepeated cache: decode reads it once
        qg = q.view(B, nkv, g, hd)
        logits = torch.matmul(qg, kk.transpose(-1, -2)).float() / math.sqrt(hd)
        if quant:   # per-token k scales fold into the logits before the mask
            logits = logits * ks_c[i].transpose(-1, -2)
        logits = logits.masked_fill(~keep, -1e30)
        w = torch.softmax(logits, -1).to(x.dtype)
        if quant:   # per-token v scales fold into the weights after softmax
            w = w * vs_c[i].transpose(-1, -2).to(w.dtype)
        att = torch.matmul(w, vv).reshape(B, 1, H)
        x = _finish_layer(layer, x, att)
    x = model.norm(x)[:, 0]
    return model.lm_head(x).float(), k_cache, v_cache


def _penalize(logits, seen, repetition_penalty):
    """HF repetition penalty: positive logits of seen tokens divided,
    negative ones multiplied."""
    return torch.where(seen > 0, torch.where(logits > 0, logits / repetition_penalty,
                                             logits * repetition_penalty), logits)


def filtered_probs(logits, temperature: float, top_p: float, top_k: int = 0):
    """The distribution :func:`_sample` draws from: softmax(logits / T), top-k
    keeps every prob >= the k-th largest (ties kept), then top-p keeps every
    prob >= the cutoff at the first index where the descending cumulative
    sum reaches ``top_p``; renormalized."""
    probs = torch.softmax(logits.float() / temperature, -1)
    if top_k and 0 < top_k < probs.shape[-1]:
        kth = torch.sort(probs, -1).values[:, -top_k][:, None]
        probs = torch.where(probs >= kth, probs, 0.0)
    srt = torch.sort(probs, -1, descending=True).values
    cum = torch.cumsum(srt, -1)
    cut_idx = (cum >= top_p).int().argmax(-1)
    cutoff = srt.gather(-1, cut_idx[:, None])
    probs = torch.where(probs >= cutoff, probs, 0.0)
    return probs / probs.sum(-1, keepdim=True)


def _sample(logits, generator, temperature, top_p, seen=None,
            repetition_penalty=1.0, top_k=0):
    """Next tokens (B,) int64: argmax at temperature 0, else one draw from
    :func:`filtered_probs` with ``generator`` (the exponential race,
    argmax p / E, E ~ Exp(1), which needs no host sync)."""
    if repetition_penalty != 1.0 and seen is not None:
        logits = _penalize(logits, seen, repetition_penalty)
    if temperature == 0.0:
        return logits.argmax(-1)
    probs = filtered_probs(logits, temperature, top_p, top_k)
    e = torch.empty_like(probs).exponential_(generator=generator)
    return (probs / e).argmax(-1)


def _count(seen, rows, ids, counts):
    """seen[rows, ids] += counts with repeated ids counted."""
    seen.index_put_((rows, ids), counts.to(seen.dtype), accumulate=True)


@torch.inference_mode()
def generate(model, inputs_embeds, attention_mask, *, max_new_tokens: int = 64,
             temperature: float = 0.0, top_p: float = 0.9, top_k: int = 0,
             eos_token_id: int = 2, generator: torch.Generator | None = None,
             repetition_penalty: float = 1.0, kv_int8: bool = False,
             prompt_token_ids=None, positions=None, prefix=None,
             prefix_token_ids=None) -> torch.Tensor:
    """Batched generation from (possibly AV-spliced) prompt embeddings on the
    model's device.

    inputs_embeds (B, S, H) right-padded, attention_mask (B, S). Returns
    (B, max_new_tokens) int64, EOS-padded after the first EOS.
    ``prompt_token_ids`` (B, S) seed the repetition penalty with the prompt;
    ``prefix`` is a shared-prefix KV from :func:`prefill_prefix` (the embeds
    then hold only the suffixes) and ``prefix_token_ids`` (P,) seed the
    penalty with it."""
    cfg = model.cfg
    dev = model.norm.weight.device
    B, S, _ = inputs_embeds.shape
    mask = attention_mask.to(dev)
    P = prefix[0].shape[2] if prefix is not None else 0
    logits0, kc, vc, n_valid = prefill(model, inputs_embeds, mask,
                                       P + S + max_new_tokens, kv_int8=kv_int8,
                                       positions=positions, prefix=prefix)
    if max_new_tokens == 0:
        return torch.zeros(B, 0, dtype=torch.long, device=dev)
    if positions is not None and cfg.mrope_section is not None:
        # M-RoPE: every generated token advances all three components from
        # the prompt's max valid position (HF rope_deltas semantics)
        positions = positions.to(dev)
        pmax = torch.where(mask[:, :, None] > 0, positions, -1).amax(dim=(1, 2))
        mk_pos = lambda t: (pmax + 1 + t)[:, None].expand(B, 3)  # noqa: E731
    else:
        mk_pos = lambda t: n_valid + t  # noqa: E731
    slot_mask = torch.zeros(B, P + S + max_new_tokens, dtype=torch.bool, device=dev)
    slot_mask[:, :P] = True
    slot_mask[:, P: P + S] = mask.bool()

    rows = torch.arange(B, device=dev)
    seen = None
    if repetition_penalty != 1.0:
        seen = torch.zeros(B, cfg.vocab_size, dtype=torch.int32, device=dev)
        if prompt_token_ids is not None:
            ids = prompt_token_ids.to(dev).long()
            _count(seen, rows[:, None].expand_as(ids), ids, mask)
        if prefix_token_ids is not None:
            pre = prefix_token_ids.to(dev).long()[None].expand(B, -1)
            _count(seen, rows[:, None].expand_as(pre), pre, torch.ones_like(pre))
    samp = dict(generator=generator, temperature=temperature, top_p=top_p,
                repetition_penalty=repetition_penalty, top_k=top_k)
    tok = _sample(logits0, seen=seen, **samp)
    done = tok == eos_token_id
    if seen is not None:
        _count(seen, rows, tok, torch.ones_like(tok))
    out = [tok]
    for t in range(max_new_tokens - 1):
        slot = P + S + t
        slot_mask[:, slot] = True
        logits, kc, vc = _step(model, tok, mk_pos(t), slot, kc, vc, slot_mask)
        nxt = torch.where(done, eos_token_id, _sample(logits, seen=seen, **samp))
        done = done | (nxt == eos_token_id)
        if seen is not None:
            _count(seen, rows, nxt, torch.ones_like(nxt))
        out.append(nxt)
        tok = nxt
    return torch.stack(out, 1)


@torch.inference_mode()
def decode_logits(model, inputs_embeds, attention_mask, tokens, kv_int8: bool = False):
    """The cached path's logits with ``tokens`` (B, T) teacher-forced:
    prefill's last logits, then one decode step per token of
    ``tokens[:, :-1]``. Returns (B, T, V) fp32, the logits that chose each
    token of ``tokens`` in :func:`generate`."""
    dev = model.norm.weight.device
    B, S, _ = inputs_embeds.shape
    T = tokens.shape[1]
    mask = attention_mask.to(dev)
    logits, kc, vc, n_valid = prefill(model, inputs_embeds, mask, S + T, kv_int8=kv_int8)
    slot_mask = torch.zeros(B, S + T, dtype=torch.bool, device=dev)
    slot_mask[:, :S] = mask.bool()
    out = [logits]
    for t in range(T - 1):
        slot_mask[:, S + t] = True
        logits, kc, vc = _step(model, tokens[:, t].to(dev), n_valid + t, S + t, kc, vc,
                               slot_mask)
        out.append(logits)
    return torch.stack(out, 1)


@torch.inference_mode()
def teacher_forced_logits(model, inputs_embeds, attention_mask, tokens):
    """``LLM.forward`` (no cache) on each row's valid prompt followed by the
    embeddings of ``tokens`` (B, T), packed left: the (B, T, V) fp32 logits
    at the positions :func:`decode_logits` computes them."""
    dev = model.norm.weight.device
    B, S, H = inputs_embeds.shape
    T = tokens.shape[1]
    mask = attention_mask.to(dev).bool()
    n = mask.sum(1)
    x = torch.zeros(B, S + T, H, dtype=inputs_embeds.dtype, device=dev)
    am = torch.zeros(B, S + T, dtype=torch.long, device=dev)
    tok_emb = model.embed_tokens.weight[tokens.to(dev)].to(inputs_embeds.dtype)
    for b in range(B):
        nb = int(n[b])
        x[b, :nb] = inputs_embeds[b].to(dev)[mask[b]]
        x[b, nb: nb + T] = tok_emb[b]
        am[b, : nb + T] = 1
    logits = model(x, am).float()
    idx = (n - 1)[:, None] + torch.arange(T, device=dev)[None]
    return logits.gather(1, idx[..., None].expand(B, T, logits.shape[-1]))


def common_token_prefix(ids_lists, min_prefix: int = 16) -> int:
    """Longest common token prefix across prompts, capped so every prompt
    keeps at least one suffix token (the last-logit position); 0 when the
    result is shorter than ``min_prefix`` or there is only one prompt."""
    if len(ids_lists) < 2:
        return 0
    first = list(ids_lists[0])
    P = len(first)
    for ids in ids_lists[1:]:
        m = min(P, len(ids))
        j = 0
        while j < m and ids[j] == first[j]:
            j += 1
        P = j
        if P < min_prefix:
            return 0
    P = min(P, min(len(ids) for ids in ids_lists) - 1)
    return P if P >= min_prefix else 0


def bucket_len(n: int, mult: int = 64, cap: int | None = None) -> int:
    """Round a ragged length up to a multiple of ``mult`` (at least ``mult``),
    capped at ``cap``. Pad positions carry mask 0 everywhere here, so bucketed
    padding leaves every output as it is."""
    b = max(mult, ((n + mult - 1) // mult) * mult)
    return min(b, cap) if cap is not None else b


def make_generator(device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


@torch.inference_mode()
def batch_generate_texts(model, ids_by_key: dict, tok, *, batch: int = 8,
                         max_new_tokens: int = 64, temperature: float = 0.0,
                         top_p: float = 0.9, top_k: int = 0,
                         repetition_penalty: float = 1.0, kv_int8: bool = False,
                         seed: int = 0, shared_prefix: bool = True,
                         min_prefix: int = 16, progress=None,
                         device="cuda") -> dict:
    """Length-sorted, bucket-padded batched decoding of many token prompts
    (the OV-extraction, translation, synonym and punctuation CLIs' scheduler).

    Keys go in prompt-length order, each batch pads to a 64-token bucket and
    a short last batch is filled with dummy rows whose output is thrown
    away. With ``shared_prefix`` the longest common token prefix of all
    prompts (at least ``min_prefix``) is prefilled once and reused. Runs on
    ``device`` (the card unless the caller asks for ``"cpu"``; a host without
    a card raises); the model is moved there. Returns {key: decoded text},
    EOS stripped."""
    from ..core.device import resolve_device

    dev = resolve_device(device, fp32=_cache_dtype(model) == torch.float32)
    model.to(dev)
    table = model.embed_tokens.weight
    order = sorted(ids_by_key, key=lambda k: len(ids_by_key[k]))

    P = 0
    prefix = pre_ids = None
    if shared_prefix and len(order) > 1:
        P = common_token_prefix([ids_by_key[k] for k in order], min_prefix=min_prefix)
        if P:
            pre_ids = torch.as_tensor(list(ids_by_key[order[0]])[:P], device=dev)
            prefix = prefill_prefix(model, table[pre_ids].float())
            if progress:
                progress(f"  shared prefix: {P} tokens prefilled once")

    eos = int(tok.eos_token_id)
    out = {}
    for i in range(0, len(order), batch):
        group = order[i: i + batch]
        ids_list = [list(ids_by_key[k])[P:] for k in group]
        S = bucket_len(max(len(x) for x in ids_list))
        ids = np.zeros((batch, S), np.int64)
        mask = np.zeros((batch, S), np.int64)
        for b, row in enumerate(ids_list):
            ids[b, : len(row)] = row
            mask[b, : len(row)] = 1
        real = torch.from_numpy(mask).to(dev)
        mask[len(group):, 0] = 1   # dummy rows decode garbage that is discarded
        ids_t = torch.from_numpy(ids).to(dev)
        embeds = table[ids_t].float() * real[..., None]
        tokens = generate(
            model, embeds, torch.from_numpy(mask).to(dev),
            max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p,
            top_k=top_k, repetition_penalty=repetition_penalty, eos_token_id=eos,
            kv_int8=kv_int8, generator=make_generator(dev, seed * 100003 + i),
            prompt_token_ids=ids_t if repetition_penalty != 1.0 else None,
            prefix=prefix,
            prefix_token_ids=pre_ids if repetition_penalty != 1.0 else None).cpu().numpy()
        for b, k in enumerate(group):
            toks = tokens[b]
            stop = np.nonzero(toks == eos)[0]
            out[k] = tok.decode((toks[: stop[0]] if len(stop) else toks).tolist(),
                                skip_special_tokens=True)
        if progress:
            progress(f"  {len(out)}/{len(ids_by_key)}")
    return out
