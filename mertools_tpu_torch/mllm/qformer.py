"""Q-Former: learned query tokens that compress encoder features — port of
``mertools_tpu/mllm/qformer.py`` (``QFormerConfig``, ``QFormer``, and
``from_blip2_qformer`` as a state-dict loader).

Each layer: self-attention over the queries, cross-attention to the (masked)
encoder sequence every ``cross_attention_freq`` layers, and a GELU MLP, each
followed by a post-LN (eps 1e-12). Parameter names follow the Flax modules
(``self_attn_{i}.q``, ``cross_ln_{i}``, ``ffn1_{i}``, ``query_tokens``), so
:func:`state_dict_from_flax` is a rename and a transpose. The attention is
plain PyTorch: the JAX package runs no kernel here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .llm import LayerNorm, Linear


@dataclass(frozen=True)
class QFormerConfig:
    num_queries: int = 32
    hidden_size: int = 768
    num_layers: int = 2
    num_heads: int = 12
    intermediate_size: int = 3072
    cross_attention_freq: int = 1
    layer_norm_eps: float = 1e-12
    # BLIP-2 checkpoint compatibility: cross-attn k/v consume the raw
    # encoder width, and the query tokens pass through a LayerNorm first
    project_encoder: bool = True
    query_layernorm: bool = False
    # text-conditioned mode (QFormerText: preference judges, ROADMAP A13)
    vocab_size: int | None = None
    max_position_embeddings: int = 512


class _MHA(nn.Module):
    def __init__(self, hidden: int, heads: int, kv_dim: int, device=None):
        super().__init__()
        self.heads = heads
        self.q = Linear(hidden, hidden, device=device)
        self.k = Linear(kv_dim, hidden, device=device)
        self.v = Linear(kv_dim, hidden, device=device)
        self.out = Linear(hidden, hidden, device=device)

    def forward(self, q_in, kv_in, bias=None):
        B, Q, H = q_in.shape
        hd = H // self.heads
        q = self.q(q_in).view(B, Q, self.heads, hd)
        k = self.k(kv_in).view(B, kv_in.shape[1], self.heads, hd)
        v = self.v(kv_in).view(B, kv_in.shape[1], self.heads, hd)
        logits = torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(hd)
        if bias is not None:
            logits = logits + bias
        w = torch.softmax(logits.float(), -1).to(q_in.dtype)
        return self.out(torch.einsum("bnqk,bknd->bqnd", w, v).reshape(B, Q, H))


class QFormer(nn.Module):
    """(encoder_feats (B, T, enc_dim)[, mask (B, T)]) -> (B, num_queries, H)."""

    def __init__(self, cfg: QFormerConfig, enc_dim: int, device=None):
        super().__init__()
        c = self.cfg = cfg
        H = c.hidden_size
        self.query_tokens = nn.Parameter(torch.empty(c.num_queries, H,
                                                     device=device))
        if c.query_layernorm:
            self.query_ln = LayerNorm(H, eps=c.layer_norm_eps, device=device)
        kv_dim = enc_dim
        if c.project_encoder and enc_dim != H:
            self.enc_proj = Linear(enc_dim, H, device=device)
            kv_dim = H
        for i in range(c.num_layers):
            self.add_module(f"self_attn_{i}", _MHA(H, c.num_heads, H, device))
            self.add_module(f"self_ln_{i}", LayerNorm(H, eps=c.layer_norm_eps,
                                                      device=device))
            if i % c.cross_attention_freq == 0:
                self.add_module(f"cross_attn_{i}",
                                _MHA(H, c.num_heads, kv_dim, device))
                self.add_module(f"cross_ln_{i}",
                                LayerNorm(H, eps=c.layer_norm_eps, device=device))
            self.add_module(f"ffn1_{i}", Linear(H, c.intermediate_size,
                                                device=device))
            self.add_module(f"ffn2_{i}", Linear(c.intermediate_size, H,
                                                device=device))
            self.add_module(f"ffn_ln_{i}", LayerNorm(H, eps=c.layer_norm_eps,
                                                     device=device))

    def forward(self, enc_feats, enc_mask=None):
        c = self.cfg
        B = enc_feats.shape[0]
        x = self.query_tokens.to(enc_feats.dtype).expand(B, -1, -1)
        if c.query_layernorm:
            x = self.query_ln(x)
        if hasattr(self, "enc_proj"):
            enc_feats = self.enc_proj(enc_feats)
        cross_bias = None
        if enc_mask is not None:
            cross_bias = torch.where(enc_mask[:, None, None, :] > 0, 0.0, -1e30)
        for i in range(c.num_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            x = layer("self_ln")(x + layer("self_attn")(x, x))
            if i % c.cross_attention_freq == 0:
                x = layer("cross_ln")(x + layer("cross_attn")(x, enc_feats,
                                                              cross_bias))
            h = layer("ffn2")(F.gelu(layer("ffn1")(x)))   # exact (erf) GELU
            x = layer("ffn_ln")(x + h)
        return x


def state_dict_from_flax(tree, prefix: str = "") -> dict:
    """The JAX package's ``QFormer`` param tree, or any Flax subtree of Dense /
    LayerNorm / Embed modules and bare params -> this package's state-dict
    entries under ``prefix``: ``kernel`` -> ``weight`` transposed, LayerNorm
    ``scale`` -> ``weight``, Embed ``embedding`` -> ``weight``."""
    sd = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            sd.update(state_dict_from_flax(leaf, f"{prefix}{name}."))
            continue
        arr = np.array(leaf, np.float32)
        if name == "kernel":
            name, arr = "weight", arr.T
        elif name in ("scale", "embedding"):
            name = "weight"
        sd[f"{prefix}{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().clone()
    return torch.from_numpy(np.array(x, np.float32))


def from_blip2_qformer(sd: dict, prefix: str = "Qformer.bert.",
                       attn_inner: str = "self", num_heads: int | None = None
                       ) -> tuple[QFormerConfig, dict]:
    """A BLIP-2 Q-Former state dict (LAVIS ``Qformer.bert.*`` with
    ``attention.self.query``; HF ``Blip2QFormerModel`` with ``prefix=""``,
    ``attn_inner="attention"`` and ``layernorm``) -> (QFormerConfig, this
    module's state dict). Only the query path is mapped (the reference
    deletes the text branch). Build the module as ``QFormer(cfg, enc_dim)``
    with ``enc_dim = sd["cross_attn_0.k.weight"].shape[1]``."""
    n_layers = 1 + max(int(k.removeprefix(f"{prefix}encoder.layer.").split(".")[0])
                       for k in sd if k.startswith(f"{prefix}encoder.layer."))
    H = sd[f"{prefix}encoder.layer.0.attention.{attn_inner}.query.weight"].shape[0]
    inter = sd[f"{prefix}encoder.layer.0.intermediate_query.dense.weight"].shape[0]
    has_cross = [i for i in range(n_layers) if
                 f"{prefix}encoder.layer.{i}.crossattention.{attn_inner}.query.weight"
                 in sd]
    freq = has_cross[1] - has_cross[0] if len(has_cross) > 1 else n_layers
    num_q = sd["query_tokens"].shape[1] if "query_tokens" in sd else 32
    cfg = QFormerConfig(num_queries=num_q, hidden_size=H, num_layers=n_layers,
                        num_heads=num_heads or 12, intermediate_size=inter,
                        cross_attention_freq=freq, project_encoder=False,
                        query_layernorm=True)
    out = {}

    def put(name, key):
        out[f"{name}.weight"] = _tensor(sd[f"{key}.weight"])
        out[f"{name}.bias"] = _tensor(sd[f"{key}.bias"])

    put("query_ln", f"{prefix}embeddings.LayerNorm"
        if f"{prefix}embeddings.LayerNorm.weight" in sd
        else f"{prefix.removesuffix('bert.')}layernorm")
    if "query_tokens" in sd:
        out["query_tokens"] = _tensor(sd["query_tokens"]).reshape(num_q, H)
    for i in range(n_layers):
        lp = f"{prefix}encoder.layer.{i}"
        for kind, src in (("self", "attention"), ("cross", "crossattention")):
            if kind == "cross" and i not in has_cross:
                continue
            for ours, theirs in (("q", "query"), ("k", "key"), ("v", "value")):
                put(f"{kind}_attn_{i}.{ours}", f"{lp}.{src}.{attn_inner}.{theirs}")
            put(f"{kind}_attn_{i}.out", f"{lp}.{src}.output.dense")
            put(f"{kind}_ln_{i}", f"{lp}.{src}.output.LayerNorm")
        put(f"ffn1_{i}", f"{lp}.intermediate_query.dense")
        put(f"ffn2_{i}", f"{lp}.output_query.dense")
        put(f"ffn_ln_{i}", f"{lp}.output_query.LayerNorm")
    return cfg, out
