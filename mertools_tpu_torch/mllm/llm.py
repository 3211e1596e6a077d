"""Decoder-only LLM backbone (LLaMA/Qwen2-style) with LoRA, in PyTorch —
port of ``mertools_tpu/mllm/llm.py``.

RMSNorm, rotary position embeddings (M-RoPE optional), GQA attention, SwiGLU
MLP, separate or tied LM head. Parameters carry HF ``LlamaModel`` /
``Qwen2Model`` key names (``embed_tokens``, ``layers.{i}.self_attn.q_proj``,
``layers.{i}.mlp.gate_proj``, ``norm``, ``lm_head``), so an HF state dict
loads through :func:`load_hf_state_dict` without a converter. LoRA adds
``lora_A`` (r, in) and ``lora_B`` (out, r) beside each of the seven
projections, scaled by ``alpha / r``; the base is frozen by
``requires_grad`` (:func:`set_lora_trainable`).

Every parameter is cast to its input's dtype where it is used, so a model
whose frozen base is held in bf16 and whose trainable leaves are fp32 master
copies computes in bf16 throughout, as the JAX Runner's ``cast_tree`` does.

With ``use_flash_attention`` the attention is kernel B3
(:mod:`..ops.flash_attention_causal`) with segment ids from the attention
mask (valid 1, pad 0), forward and backward; otherwise the eager path with
its -1e30 additive bias. The eager path masks keys only, so pad query rows
differ between the two; valid rows agree.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention_causal import (SUPPORTED_HEAD_DIMS,
                                          flash_attention_causal)

REMAT_POLICIES = ("full", "dots")


@dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    lora_r: int = 0          # 0 = no LoRA
    lora_alpha: float = 16.0
    attention_bias: bool = False  # True for Qwen2-style q/k/v biases
    # M-RoPE (Qwen2-VL/Qwen2.5-VL): rotary bands split among the (t, h, w)
    # components of 3-D position ids. None = standard RoPE.
    mrope_section: tuple[int, ...] | None = None
    # Kernel B3 for the training forward and backward (hd 64 or 128)
    use_flash_attention: bool = False
    # Recompute each decoder layer on the backward pass: "full" checkpoints
    # the whole layer (torch.utils.checkpoint); "dots" saves every matmul
    # output and recomputes only the cheap elementwise and norm ops.
    remat: bool = False
    remat_policy: str = "full"
    # sequence parallelism over a mesh axis: not ported (ROADMAP A14)
    seq_axis: str | None = None

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} not in "
                             f"{REMAT_POLICIES}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, vocab=128, lora_r=0):
        return cls(vocab_size=vocab, hidden_size=32, num_layers=2, num_heads=4,
                   num_kv_heads=2, intermediate_size=64, lora_r=lora_r)

    @classmethod
    def from_hf(cls, hf, lora_r=0):
        """From an HF config object or its ``config.json`` dict; Qwen2-family
        models get q/k/v biases as in the JAX package."""
        get = hf.get if isinstance(hf, dict) else (
            lambda key, default=None: getattr(hf, key, default))
        scaling = get("rope_scaling") or {}
        mrope = scaling.get("mrope_section") if isinstance(scaling, dict) else None
        return cls(vocab_size=get("vocab_size"), hidden_size=get("hidden_size"),
                   num_layers=get("num_hidden_layers"),
                   num_heads=get("num_attention_heads"),
                   num_kv_heads=get("num_key_value_heads")
                   or get("num_attention_heads"),
                   intermediate_size=get("intermediate_size"),
                   rms_norm_eps=get("rms_norm_eps"),
                   rope_theta=get("rope_theta", 10000.0) or 10000.0,
                   attention_bias=bool(get("attention_bias", False))
                   or get("model_type") in ("qwen2", "qwen2_5_vl_text",
                                            "qwen2_5_omni_text"),
                   mrope_section=tuple(mrope) if mrope else None,
                   lora_r=lora_r)


def _cast(p: torch.Tensor | None, x: torch.Tensor):
    return p if p is None or p.dtype == x.dtype else p.to(x.dtype)


class Linear(nn.Linear):
    """nn.Linear whose weight and bias follow the input's dtype."""

    def forward(self, x):
        return F.linear(x, _cast(self.weight, x), _cast(self.bias, x))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm whose scale and shift follow the input's dtype."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, _cast(self.weight, x),
                            _cast(self.bias, x), self.eps)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        var = x.float().pow(2).mean(-1, keepdim=True)  # variance in fp32
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * _cast(self.weight, x)


@functools.lru_cache(maxsize=None)
def _rope_tables(hd: int, theta: float, mrope_section, device: torch.device):
    """(inv_freq (hd/2,) fp32 with numpy's rounding as in the JAX package,
    M-RoPE component index or None), one copy per device: building them in
    every call would be a blocking host-to-device copy in every layer."""
    inv_freq = torch.from_numpy(
        1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))).to(device)
    if mrope_section is None:
        return inv_freq, None
    comp = np.repeat(np.arange(3), mrope_section)
    if len(comp) != hd // 2:
        raise ValueError(f"mrope_section {mrope_section} does not cover "
                         f"head dim {hd}")
    return inv_freq, torch.from_numpy(comp).to(device)


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float,
           mrope_section: tuple[int, ...] | None = None) -> torch.Tensor:
    """x: (B, S, N, Hd); positions: (B, S), or (B, S, 3) t/h/w ids with
    ``mrope_section`` (frequency band i uses component
    ``repeat(arange(3), mrope_section)[i]``). HF-style half rotation in fp32;
    the result is cast back to x's dtype."""
    hd = x.shape[-1]
    inv_freq, comp = _rope_tables(hd, float(theta), mrope_section, x.device)
    if comp is not None and positions.dim() == 3:
        ang = positions[..., comp].float() * inv_freq
    else:
        ang = positions[..., None].float() * inv_freq           # (B, S, Hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., : hd // 2].float(), x[..., hd // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


class LoRALinear(nn.Module):
    """Linear (HF layout: weight (out, in)) with an optional low-rank delta
    ``(alpha / r) * x A^T B^T``; A (r, in), B (out, r)."""

    def __init__(self, in_features: int, out_features: int, lora_r: int = 0,
                 lora_alpha: float = 16.0, bias: bool = False, device=None):
        super().__init__()
        self.lora_r, self.scale = lora_r, (lora_alpha / lora_r if lora_r else 0.0)
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)
        if lora_r > 0:
            self.lora_A = nn.Parameter(torch.empty(lora_r, in_features,
                                                   device=device))
            self.lora_B = nn.Parameter(torch.zeros(out_features, lora_r,
                                                   device=device))

    def forward(self, x):
        y = F.linear(x, _cast(self.weight, x), _cast(self.bias, x))
        if self.lora_r > 0:
            y = y + self.scale * F.linear(F.linear(x, _cast(self.lora_A, x)),
                                          _cast(self.lora_B, x))
        return y


class _Attention(nn.Module):
    def __init__(self, c: LLMConfig, device=None):
        super().__init__()
        H, hd = c.hidden_size, c.head_dim
        lin = functools.partial(LoRALinear, lora_r=c.lora_r,
                                lora_alpha=c.lora_alpha, device=device)
        self.q_proj = lin(H, c.num_heads * hd, bias=c.attention_bias)
        self.k_proj = lin(H, c.num_kv_heads * hd, bias=c.attention_bias)
        self.v_proj = lin(H, c.num_kv_heads * hd, bias=c.attention_bias)
        self.o_proj = lin(c.num_heads * hd, H)
        self.cfg = c

    def forward(self, x, positions, mask):
        """mask: (B, S) int32 segment ids on the flash path, else the
        (B|1, 1, S, S) additive fp32 bias."""
        c = self.cfg
        B, S, _ = x.shape
        nh, nkv, hd = c.num_heads, c.num_kv_heads, c.head_dim
        q = rotary(self.q_proj(x).view(B, S, nh, hd), positions, c.rope_theta,
                   c.mrope_section)
        k = rotary(self.k_proj(x).view(B, S, nkv, hd), positions, c.rope_theta,
                   c.mrope_section)
        v = self.v_proj(x).view(B, S, nkv, hd)
        if c.use_flash_attention:   # GQA kv heads are indexed, not repeated
            attn = flash_attention_causal(q, k, v, mask)
        else:
            if nkv != nh:
                k = k.repeat_interleave(nh // nkv, dim=2)
                v = v.repeat_interleave(nh // nkv, dim=2)
            logits = torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(hd)
            w = torch.softmax((logits + mask).float(), -1).to(x.dtype)
            attn = torch.einsum("bnqk,bknd->bqnd", w, v)
        return self.o_proj(attn.reshape(B, S, nh * hd))


class _MLP(nn.Module):
    def __init__(self, c: LLMConfig, device=None):
        super().__init__()
        lin = functools.partial(LoRALinear, lora_r=c.lora_r,
                                lora_alpha=c.lora_alpha, device=device)
        self.gate_proj = lin(c.hidden_size, c.intermediate_size)
        self.up_proj = lin(c.hidden_size, c.intermediate_size)
        self.down_proj = lin(c.intermediate_size, c.hidden_size)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class _LLMLayer(nn.Module):
    def __init__(self, c: LLMConfig, device=None):
        super().__init__()
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, device)
        self.self_attn = _Attention(c, device)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps,
                                                device)
        self.mlp = _MLP(c, device)

    def forward(self, x, positions, mask):
        x = x + self.self_attn(self.input_layernorm(x), positions, mask)
        return x + self.mlp(self.post_attention_layernorm(x))


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat_policy="dots": keep every matmul
    output, recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    matmuls = (aten.mm.default, aten.addmm.default, aten.bmm.default,
               aten.baddbmm.default)
    return (CheckpointPolicy.MUST_SAVE if op in matmuls
            else CheckpointPolicy.PREFER_RECOMPUTE)


class LLM(nn.Module):
    """Causal LM over input embeddings (the MLLM splices AV tokens, so the
    entry point takes ``inputs_embeds``; :meth:`embed` looks tokens up).
    ``device`` builds the parameters there; on a CUDA device a flash config
    must have a head dim kernel B3 takes."""

    def __init__(self, cfg: LLMConfig, device=None):
        super().__init__()
        if cfg.seq_axis:
            raise NotImplementedError(
                "LLMConfig.seq_axis (sequence-parallel ring attention) is not "
                "ported to mertools_tpu_torch yet (ROADMAP A14)")
        if cfg.use_flash_attention and device is not None \
                and torch.device(device).type == "cuda" \
                and cfg.head_dim not in SUPPORTED_HEAD_DIMS:
            raise ValueError(f"use_flash_attention on {device}: head dim "
                             f"{cfg.head_dim} not in {SUPPORTED_HEAD_DIMS} "
                             f"(kernel B3)")
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device)
        self.layers = nn.ModuleList(_LLMLayer(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                              device=device)

    def embed(self, input_ids):
        return self.embed_tokens(input_ids.long())

    def _mask(self, B, S, attention_mask, device):
        if self.cfg.use_flash_attention:   # pads get segment 0 != 1
            if attention_mask is None:
                return torch.ones(B, S, dtype=torch.int32, device=device)
            return attention_mask.to(device, torch.int32).contiguous()
        ar = torch.arange(S, device=device)
        bias = torch.where(ar[:, None] >= ar[None, :], 0.0, -1e30)[None, None]
        if attention_mask is not None:
            bias = bias + torch.where(attention_mask.to(device)[:, None, None, :]
                                      > 0, 0.0, -1e30)
        return bias

    def _trunk(self, x, attention_mask, positions):
        """Every layer's input and the last layer's output."""
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)
        mask = self._mask(B, S, attention_mask, x.device)
        hs = [x]
        for layer in self.layers:
            if self.cfg.remat and torch.is_grad_enabled():
                from torch.utils.checkpoint import (
                    checkpoint, create_selective_checkpoint_contexts)

                kw = {}
                if self.cfg.remat_policy == "dots":
                    kw["context_fn"] = functools.partial(
                        create_selective_checkpoint_contexts, _save_matmuls)
                x = checkpoint(layer, x, positions, mask, use_reentrant=False,
                               **kw)
            else:
                x = layer(x, positions, mask)
            hs.append(x)
        return hs

    def forward(self, inputs_embeds, attention_mask=None, positions=None,
                output_hidden_states: bool = False):
        """inputs_embeds (B, S, H); attention_mask (B, S) 1 = valid. Returns
        logits (B, S, V); with ``output_hidden_states``, (logits, hs) where hs
        follows HF: the embeddings, each layer's output, the last replaced by
        the final-norm output."""
        hs = self._trunk(inputs_embeds, attention_mask, positions)
        hs[-1] = self.norm(hs[-1])
        logits = self.lm_head(hs[-1])
        return (logits, tuple(hs)) if output_hidden_states else logits

    def hidden(self, inputs_embeds, attention_mask=None, positions=None):
        """Final-norm hidden states (B, S, H), without the lm_head."""
        return self.norm(self._trunk(inputs_embeds, attention_mask,
                                     positions)[-1])

    def loss(self, inputs_embeds, labels, attention_mask=None, positions=None,
             chunk: int = 0, ignore_index: int = -100):
        """Causal LM loss; ``chunk`` > 0 runs the lm_head and cross-entropy
        over sequence chunks, never holding the (B, S, V) logits at once.
        Equals :func:`lm_loss` on the full logits up to fp32 summation order."""
        if chunk <= 0:
            return lm_loss(self(inputs_embeds, attention_mask, positions),
                           labels, ignore_index)
        S = inputs_embeds.shape[1]
        h = self.hidden(inputs_embeds, attention_mask, positions)[:, :-1]
        lab = labels[:, 1:].to(h.device)
        n_sum = torch.zeros((), device=h.device)
        n_cnt = torch.zeros((), device=h.device)
        for i in range(0, S - 1, chunk):
            logits = self.lm_head(h[:, i: i + chunk]).float()
            lb = lab[:, i: i + chunk]
            mask = lb != ignore_index
            tgt = logits.gather(-1, torch.where(mask, lb, 0)[..., None].long())[..., 0]
            n_sum = n_sum + ((torch.logsumexp(logits, -1) - tgt) * mask).sum()
            n_cnt = n_cnt + mask.sum()
        return n_sum / n_cnt.clamp(min=1)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            ignore_index: int = -100) -> torch.Tensor:
    """Shifted causal LM cross-entropy with -100 masking (HF semantics)."""
    logits = logits[:, :-1].float()
    labels = labels[:, 1:].to(logits.device)
    mask = labels != ignore_index
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, torch.where(mask, labels, 0)[..., None].long())[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def set_lora_trainable(model: nn.Module) -> None:
    """requires_grad on the LoRA deltas only (the JAX ``lora_param_labels``
    'lora' leaves); the base stays frozen and gets no gradient."""
    for name, p in model.named_parameters():
        p.requires_grad_(name.rsplit(".", 1)[-1] in ("lora_A", "lora_B"))


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every parameter in place with the JAX modules'
    initialisers: lecun-normal (truncated at two standard deviations) Linear
    weights, zero biases, normal(0.02) LoRA A and zero LoRA B, unit norm
    scales and zero LayerNorm shifts, normal(1/sqrt(D)) token embeddings,
    normal(0.02) for the rest (query tokens, position tables). The draws
    differ from JAX's (another generator); the scales match."""
    def trunc(t):
        std = math.sqrt(1.0 / t.shape[1]) / 0.87962566103423978
        nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                              generator=generator)

    with torch.no_grad():
        for mod in model.modules():
            own = dict(mod.named_parameters(recurse=False))
            if isinstance(mod, (nn.Linear, LoRALinear)):
                trunc(mod.weight)
                if mod.bias is not None:
                    mod.bias.zero_()
                if isinstance(mod, LoRALinear) and mod.lora_r:
                    mod.lora_A.normal_(0.0, 0.02, generator=generator)
                    mod.lora_B.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5,
                                   generator=generator)
            elif isinstance(mod, (RMSNorm, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            else:
                for p in own.values():
                    p.normal_(0.0, 0.02, generator=generator)


# ---------------------------------------------------------------------------
# parameters: HF checkpoints and the JAX package's Flax trees
# ---------------------------------------------------------------------------
def load_hf_state_dict(sd: dict) -> dict:
    """HF ``LlamaForCausalLM`` / ``Qwen2ForCausalLM`` (or the bare model's)
    state dict -> this module's state dict. The keys are HF's without the
    ``model.`` prefix; a model without ``lm_head.weight`` ties the head to
    ``embed_tokens``; rotary buffers are dropped. Load it with
    ``strict=False``: only the LoRA deltas are missing, and keep their init."""
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    out = {k[len(pre):]: v for k, v in sd.items()
           if k.startswith(pre) and "rotary_emb" not in k}
    out["lm_head.weight"] = sd.get("lm_head.weight", out["embed_tokens.weight"])
    return out


def state_dict_from_flax(cfg: LLMConfig, params) -> dict:
    """The JAX package's ``LLM`` param tree (numpy-convertible leaves) -> this
    module's state dict."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    sd = {"embed_tokens.weight": t(params["embed_tokens"]["embedding"]),
          "norm.weight": t(params["norm"]["weight"]),
          "lm_head.weight": t(np.asarray(params["lm_head"]["kernel"]).T)}
    for i in range(cfg.num_layers):
        p, pre = params[f"layer_{i}"], f"layers.{i}"
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{pre}.{n}.weight"] = t(p[n]["weight"])
        for n in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                  "up_proj", "down_proj"):
            key = f"{pre}.{'self_attn' if n[0] in 'qkvo' else 'mlp'}.{n}"
            sd[f"{key}.weight"] = t(np.asarray(p[n]["kernel"]).T)
            if "bias" in p[n]:
                sd[f"{key}.bias"] = t(p[n]["bias"])
            if "lora_a" in p[n]:
                sd[f"{key}.lora_A"] = t(np.asarray(p[n]["lora_a"]).T)
                sd[f"{key}.lora_B"] = t(np.asarray(p[n]["lora_b"]).T)
    return sd
