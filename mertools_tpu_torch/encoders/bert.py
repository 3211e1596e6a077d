"""BERT-family text encoders (BERT / MacBERT / RoBERTa-wwm / RoBERTa /
ELECTRA bodies) in PyTorch — port of ``mertools_tpu/encoders/bert.py``.

Backs the reference's text feature extraction
(``MERBench/feature_extraction/text/extract_text_huggingface.py``): tokens
-> transformer returning every hidden state, for the sum of the last 4.
The Chinese MacBERT / RoBERTa-wwm checkpoints are architecturally BertModel;
RoBERTa-style position ids (English RoBERTa, XLM-R) and ELECTRA's factorised
embeddings are config switches.

Parameters carry HF ``BertModel`` state-dict key names, so a checkpoint
loads through :func:`load_hf_state_dict` alone. With ``use_flash_attention``
the attention is kernel B1 (:mod:`..ops.flash_attention`) with one key
length a row, which is exact for right-padded batches (validity is a
prefix), or its plain version on CPU tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import with_class_defaults
from ..ops.flash_attention import flash_attention
from .random_init import normal_state_dict

# HF model types whose body this module is (the text CLI's BERT branch)
BERT_MODEL_TYPES = ("bert", "roberta", "xlm-roberta", "camembert", "electra")
_ROBERTA_TYPES = ("roberta", "xlm-roberta", "camembert")
# transformers' class defaults of the keys ``BertConfig.from_hf`` reads
_BERT_DEFAULTS = dict(
    vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, max_position_embeddings=512, type_vocab_size=2,
    layer_norm_eps=1e-12, pad_token_id=0)
HF_CLASS_DEFAULTS = {
    "bert": _BERT_DEFAULTS,
    "roberta": dict(_BERT_DEFAULTS, vocab_size=50265, pad_token_id=1),
    "xlm-roberta": dict(_BERT_DEFAULTS, pad_token_id=1),
    "camembert": dict(_BERT_DEFAULTS, pad_token_id=1),
    "electra": dict(_BERT_DEFAULTS, hidden_size=256, num_attention_heads=4,
                    intermediate_size=1024, embedding_size=128),
}
# HF's BertConfig.initializer_range: the std of every weight and table of a
# fresh model
INITIALIZER_RANGE = 0.02


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 21128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    embedding_size: int | None = None  # ELECTRA-style factorised embeddings
    # RoBERTa-style position ids (cumsum from the pad id, offset by it).
    # English roberta-base/large & XLM-R; Chinese "RoBERTa" ckpts are BertModel.
    position_pad_id: int | None = None
    use_flash_attention: bool = False

    @classmethod
    def large(cls) -> "BertConfig":
        """chinese-macbert-large's geometry (its ``config.json``)."""
        return cls(hidden_size=1024, num_hidden_layers=24,
                   num_attention_heads=16, intermediate_size=4096)

    @classmethod
    def from_hf(cls, hf: dict) -> "BertConfig":
        """From a checkpoint's ``config.json`` dict, every key it lacks
        taken from ``transformers``' class defaults."""
        hf = with_class_defaults(hf, HF_CLASS_DEFAULTS)
        emb = hf.get("embedding_size")
        return cls(vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
                   num_hidden_layers=hf["num_hidden_layers"],
                   num_attention_heads=hf["num_attention_heads"],
                   intermediate_size=hf["intermediate_size"],
                   max_position_embeddings=hf["max_position_embeddings"],
                   type_vocab_size=hf["type_vocab_size"],
                   layer_norm_eps=hf["layer_norm_eps"],
                   embedding_size=(emb if emb not in (None, hf["hidden_size"])
                                   else None),
                   position_pad_id=(hf["pad_token_id"]
                                    if hf["model_type"] in _ROBERTA_TYPES
                                    else None))

    def to_config_json(self) -> dict:
        """An HF ``config.json`` dict that :meth:`from_hf` reads back as
        this config (model type ``roberta`` for RoBERTa-style positions,
        ``electra`` for factorised embeddings, else ``bert``)."""
        model_type = ("roberta" if self.position_pad_id is not None else
                      "electra" if self.embedding_size else "bert")
        out = dict(model_type=model_type, vocab_size=self.vocab_size,
                   hidden_size=self.hidden_size,
                   num_hidden_layers=self.num_hidden_layers,
                   num_attention_heads=self.num_attention_heads,
                   intermediate_size=self.intermediate_size,
                   max_position_embeddings=self.max_position_embeddings,
                   type_vocab_size=self.type_vocab_size,
                   layer_norm_eps=self.layer_norm_eps,
                   embedding_size=self.embedding_size or self.hidden_size)
        if self.position_pad_id is not None:
            out["pad_token_id"] = self.position_pad_id
        return out


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        E = cfg.embedding_size or cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, E)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, E)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, E)
        self.LayerNorm = nn.LayerNorm(E, eps=cfg.layer_norm_eps)


class _SelfAttention(nn.Module):
    def __init__(self, H: int):
        super().__init__()
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)


class _DenseNorm(nn.Module):
    """HF's ``BertSelfOutput`` / ``BertOutput``: dense, then post-LN."""

    def __init__(self, d_in: int, H: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, H)
        self.LayerNorm = nn.LayerNorm(H, eps=eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = _SelfAttention(cfg.hidden_size)
        self.output = _DenseNorm(cfg.hidden_size, cfg.hidden_size,
                                 cfg.layer_norm_eps)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class _Layer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = _Attention(cfg)
        self.intermediate = _Intermediate(cfg)
        self.output = _DenseNorm(cfg.intermediate_size, cfg.hidden_size,
                                 cfg.layer_norm_eps)

    def forward(self, x, bias, kv_len):
        B, S, H = x.shape
        nh = self.cfg.num_attention_heads
        hd = H // nh
        a = self.attention.self
        q = a.query(x).view(B, S, nh, hd)
        k = a.key(x).view(B, S, nh, hd)
        v = a.value(x).view(B, S, nh, hd)
        if self.cfg.use_flash_attention:
            # B1 takes q pre-scaled; the inline route scales the logits, as
            # the JAX package does (a rounding difference only)
            attn = flash_attention(q * hd ** -0.5, k, v, kv_len)
        else:
            logits = torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(hd)
            if bias is not None:
                logits = logits + bias
            attn = torch.einsum("bnqk,bknd->bqnd",
                                torch.softmax(logits, dim=-1), v)
        x = self.attention.output(attn.reshape(B, S, H), x)
        h = F.gelu(self.intermediate.dense(x))          # exact (erf) gelu
        return self.output(h, x)


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(cfg)
                                   for _ in range(cfg.num_hidden_layers))


class BertEncoder(nn.Module):
    """(input_ids, attention_mask[, token_type_ids]) -> tuple of hidden
    states (num_layers + 1, each (B, S, H)). Pad query rows compute values
    that callers throw away."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        if cfg.embedding_size:
            self.embeddings_project = nn.Linear(cfg.embedding_size,
                                                cfg.hidden_size)
        self.encoder = _Encoder(cfg)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                token_type_ids: torch.Tensor | None = None) -> tuple:
        c = self.cfg
        B, S = input_ids.shape
        emb = self.embeddings
        x = emb.word_embeddings(input_ids)
        if c.position_pad_id is not None:   # RoBERTa create_position_ids
            m = (input_ids != c.position_pad_id).long()
            x = x + emb.position_embeddings(torch.cumsum(m, dim=1) * m
                                            + c.position_pad_id)
        else:
            x = x + emb.position_embeddings.weight[:S][None]
        tt = (token_type_ids if token_type_ids is not None
              else torch.zeros_like(input_ids))
        x = emb.LayerNorm(x + emb.token_type_embeddings(tt))
        if c.embedding_size:
            x = self.embeddings_project(x)

        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                               -1e30).to(x.dtype)
            kv_len = attention_mask.sum(1, dtype=torch.int32)
        else:
            kv_len = torch.full((B,), S, dtype=torch.int32,
                                device=input_ids.device)

        hidden_states = [x]
        for layer in self.encoder.layer:
            x = layer(x, bias, kv_len)
            hidden_states.append(x)
        return tuple(hidden_states)


# ---------------------------------------------------------------------------
# parameters: HF checkpoints, the JAX package's Flax trees, random init
# ---------------------------------------------------------------------------
_HF_PREFIXES = ("bert.", "roberta.", "electra.")
_BODY = ("embeddings.", "encoder.", "embeddings_project.")
_BUFFERS = ("embeddings.position_ids", "embeddings.token_type_ids")


def load_hf_state_dict(sd: dict) -> dict:
    """A raw HF checkpoint's state dict (``BertModel``, or a model with a
    head: ``BertForMaskedLM`` saves ``bert.*``, RoBERTa ``roberta.*``,
    ELECTRA ``electra.*``) -> this module's state dict. Strips that prefix,
    keeps the body (heads, ``pooler.*`` and the position-id buffers go) and
    renames old ``LayerNorm.gamma`` / ``.beta`` as ``transformers`` does on
    load. Load the result with ``strict=True``."""
    out = {}
    for key, v in sd.items():
        for pre in _HF_PREFIXES:
            if key.startswith(pre):
                key = key[len(pre):]
                break
        if not key.startswith(_BODY) or key in _BUFFERS:
            continue
        if key.endswith("LayerNorm.gamma"):
            key = key[:-len("gamma")] + "weight"
        elif key.endswith("LayerNorm.beta"):
            key = key[:-len("beta")] + "bias"
        out[key] = v
    return out


def state_dict_from_flax(cfg: BertConfig, params) -> dict:
    """The JAX package's ``BertEncoder`` param tree (numpy-convertible
    leaves) -> this module's state dict; the inverse of its
    ``convert_torch_state``."""
    sd: dict = {}

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    def dense(key, p):
        sd[f"{key}.weight"] = t(np.asarray(p["kernel"]).T)
        sd[f"{key}.bias"] = t(p["bias"])

    def ln(key, p):
        sd[f"{key}.weight"] = t(p["scale"])
        sd[f"{key}.bias"] = t(p["bias"])

    sd["embeddings.word_embeddings.weight"] = t(params["word_embeddings"]["embedding"])
    sd["embeddings.position_embeddings.weight"] = t(params["position_embeddings"])
    sd["embeddings.token_type_embeddings.weight"] = t(
        params["token_type_embeddings"]["embedding"])
    ln("embeddings.LayerNorm", params["embeddings_ln"])
    if "embeddings_project" in params:
        dense("embeddings_project", params["embeddings_project"])
    for i in range(cfg.num_hidden_layers):
        p, pre = params[f"layer_{i}"], f"encoder.layer.{i}"
        for n in ("query", "key", "value"):
            dense(f"{pre}.attention.self.{n}", p[n])
        dense(f"{pre}.attention.output.dense", p["attn_out"])
        ln(f"{pre}.attention.output.LayerNorm", p["attn_ln"])
        dense(f"{pre}.intermediate.dense", p["intermediate"])
        dense(f"{pre}.output.dense", p["output"])
        ln(f"{pre}.output.LayerNorm", p["out_ln"])
    return sd


def init_params(cfg: BertConfig, generator: torch.Generator) -> dict:
    """Seeded random state dict drawn as HF's ``BertPreTrainedModel``
    initialises a fresh model: every weight and table normal(0,
    ``INITIALIZER_RANGE``)."""
    with torch.device("meta"):
        model = BertEncoder(cfg)
    return normal_state_dict(model, generator, lambda key: INITIALIZER_RANGE)
