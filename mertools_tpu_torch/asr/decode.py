"""KV-cached greedy decoding for the Whisper model — port of ``mertools_tpu/asr/decode.py``.

One encoder forward per 30 s window, then a fixed count of one-token decoder
steps over a static (layers, B, L, nh, hd) self-attention cache written in
place. The loop runs L - 1 steps whatever the tokens, as the JAX
``lax.scan`` does, so it never waits for the device: the ``done`` latch and
the prompt forcing are tensor operations.

LayerNorm uses the modules' eps (1e-5). The JAX step decoder uses 1e-6
(``mertools_tpu/asr/decode.py:22``) and so normalises differently from the
full forward it is tested against; the port's cached step and full forward
agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..encoders.whisper import WhisperConfig, WhisperModel, build_model


def _as_model(cfg: WhisperConfig, model_or_params, device) -> WhisperModel:
    if isinstance(model_or_params, WhisperModel):
        return model_or_params
    return build_model(cfg, model_or_params, device)


def precompute_cross_kv(model: WhisperModel, enc_out: torch.Tensor):
    """Per-layer cross-attention K/V from the encoder output, once per clip.
    Returns (layers, B, T, nh, hd) tensors (k, v)."""
    ks, vs = [], []
    for layer in model.decoder.layers:
        a = layer.encoder_attn
        ks.append(a.split(a.k_proj(enc_out)))
        vs.append(a.split(a.v_proj(enc_out)))
    return torch.stack(ks), torch.stack(vs)


def decoder_step(model: WhisperModel, tok: torch.Tensor, t: int,
                 self_k: torch.Tensor, self_v: torch.Tensor,
                 cross_k: torch.Tensor, cross_v: torch.Tensor) -> torch.Tensor:
    """One decode step at position ``t``: tok (B,) -> logits (B, V).

    Writes this step's keys and values into ``self_k``/``self_v``
    ((layers, B, L, nh, hd)) at position t, in place, and attends over
    positions 0..t."""
    dec = model.decoder
    emb = dec.embed_tokens.weight
    x = emb[tok] + dec.embed_positions.weight[t]                 # (B, D)
    for i, layer in enumerate(dec.layers):
        a = layer.self_attn
        h = layer.self_attn_layer_norm(x)
        q = a.query(h)                                          # (B, nh, hd)
        self_k[i, :, t] = a.split(a.k_proj(h))
        self_v[i, :, t] = a.split(a.v_proj(h))
        w = torch.softmax(torch.einsum("bnd,blnd->bnl", q, self_k[i, :, : t + 1]), -1)
        att = torch.einsum("bnl,blnd->bnd", w, self_v[i, :, : t + 1])
        x = x + a.out_proj(att.flatten(-2))

        c = layer.encoder_attn
        q = c.query(layer.encoder_attn_layer_norm(x))
        w = torch.softmax(torch.einsum("bnd,btnd->bnt", q, cross_k[i]), -1)
        x = x + c.out_proj(torch.einsum("bnt,btnd->bnd", w, cross_v[i]).flatten(-2))

        x = x + layer.fc2(F.gelu(layer.fc1(layer.final_layer_norm(x))))
    return dec.layer_norm(x) @ emb.T


@torch.inference_mode()
def greedy_decode(cfg: WhisperConfig, model_or_params, enc_out: torch.Tensor,
                  prompt: torch.Tensor, prompt_len: int,
                  max_new_tokens: int = 128,
                  suppress_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy generation. enc_out: (B, T, D); prompt: (B, prompt_len) int.

    ``model_or_params`` is a :class:`WhisperModel` or its state dict.
    Returns (B, prompt_len + max_new_tokens) int32, EOS-padded.
    suppress_mask: optional (V,) bool — True entries are never produced."""
    model = _as_model(cfg, model_or_params, enc_out.device)
    dev = enc_out.device
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    B = enc_out.shape[0]
    L = prompt_len + max_new_tokens
    eos = cfg.eos_token_id

    cross_k, cross_v = precompute_cross_kv(model, enc_out)
    self_k = torch.zeros((cfg.decoder_layers, B, L, nh, hd), dtype=enc_out.dtype,
                         device=dev)
    self_v = torch.zeros_like(self_k)
    tokens = torch.cat([prompt.to(dev, torch.int32),
                        torch.full((B, max_new_tokens), eos, dtype=torch.int32,
                                   device=dev)], dim=1)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    if suppress_mask is not None:
        suppress_mask = suppress_mask.to(dev)
    for t in range(L - 1):
        logits = decoder_step(model, tokens[:, t], t, self_k, self_v,
                              cross_k, cross_v)
        if suppress_mask is not None:
            logits = logits.masked_fill(suppress_mask[None], -1e30)
        nxt = logits.argmax(-1).to(torch.int32)
        if t + 1 < prompt_len:                  # forced prompt token
            continue
        nxt = torch.where(done, eos, nxt)
        tokens[:, t + 1] = nxt
        done |= nxt == eos
    return tokens
