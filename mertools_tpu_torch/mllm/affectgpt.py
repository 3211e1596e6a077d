"""AffectGPT-equivalent audio-video-text MLLM in PyTorch — port of
``mertools_tpu/mllm/affectgpt.py``.

Frozen-encoder features feed per-modality fusion branches (Q-Former with
frame/audio position embeddings, unnormalised linear-score ``attention``
pooling, or ``mean`` pooling), whose outputs are projected to the LLM width
and spliced into the token embeddings at placeholder runs. A ``multi`` branch
pre-fuses the raw video/audio hidden states (Q-Former or a 2-way attention
mix); an ``image`` branch projects image tokens. The segment set comes from
``face_or_frame`` (``SEGMENTS_BY_MODE``); ``face_or_frame=None`` is the
legacy single AV block. Face and frame share the video branch weights. The
LLM is LoRA-wrapped with the base frozen; the loss is causal LM CE.

Each splice writes a (B, n, H) block at a per-sample start, clamped like
``jax.lax.dynamic_update_slice`` so the block always fits. Parameter names
follow the Flax module (``video_qformer``, ``frame_position_embedding``,
``llm.layers.{i}...``), so :func:`state_dict_from_flax` carries JAX weights
across.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from ..core.device import resolve_device
from . import llm as _llm
from . import qformer as _qformer
from .llm import LLM, Linear, LLMConfig, lm_loss
from .qformer import QFormer, QFormerConfig

# Spliced placeholder segments per ``face_or_frame`` mode, in prompt order.
SEGMENTS_BY_MODE = {
    "faceframe": ("audio", "frame", "face"),
    "face": ("audio", "face"),
    "frame": ("audio", "frame"),
    "audioonly": ("audio",),
    "textonly": (),
    "faceonly": ("face",),
    "frameonly": ("frame",),
    "image": ("image",),
    "audio_text": ("audio",),
    "face_text": ("face",),
    "frame_text": ("frame",),
    "multiface_text": ("multi",),
    "multiface_audio_face_text": ("multi", "audio", "face"),
    "multiframe_audio_frame_text": ("multi", "audio", "frame"),
    "multiface_audio_face_frame_text": ("multi", "audio", "face", "frame"),
}


def stream_plan(face_or_frame: str) -> tuple[tuple[str, ...], set[str]]:
    """(spliced segments in prompt order, encoder streams to run); ``multi``
    consumes the face or frame stream (by the mode's prefix) and audio even
    where those are not spliced themselves."""
    segments = SEGMENTS_BY_MODE[face_or_frame]
    needed = {s for s in segments if s != "multi"}
    if "multi" in segments:
        needed.add("face" if face_or_frame.startswith("multiface") else "frame")
        needed.add("audio")
    return segments, needed


@dataclass(frozen=True)
class AffectGPTConfig:
    llm: LLMConfig = field(default_factory=LLMConfig.tiny)
    video_qformer: QFormerConfig = field(default_factory=lambda: QFormerConfig(num_queries=32))
    audio_qformer: QFormerConfig = field(default_factory=lambda: QFormerConfig(num_queries=8))
    multi_qformer: QFormerConfig | None = None
    video_dim: int = 768
    audio_dim: int = 1024
    image_dim: int | None = None   # None -> video_dim
    max_video_frames: int = 64
    max_audio_frames: int = 64
    multi_max_positions: int = 264
    fusion: str = "qformer"            # qformer | mean | attention
    video_fusion: str | None = None
    audio_fusion: str | None = None
    multi_fusion: str = "qformer"      # qformer | attention
    image_fusion: str = "mean"         # token | mean
    num_video_query_token: int = 1
    num_audio_query_token: int = 1
    num_multi_query_token: int = 1
    num_image_query_token: int = 1
    face_or_frame: str | None = None
    # > 0: chunked LM loss over sequence chunks of this size; the forward
    # then returns (loss, None)
    loss_chunk: int = 0

    @property
    def video_fusion_type(self) -> str:
        return self.video_fusion or self.fusion

    @property
    def audio_fusion_type(self) -> str:
        return self.audio_fusion or self.fusion

    @property
    def multi_width(self) -> int:
        return max(self.video_dim, self.audio_dim)

    @property
    def has_multi(self) -> bool:
        if self.face_or_frame is not None:
            return "multi" in SEGMENTS_BY_MODE[self.face_or_frame]
        return self.multi_qformer is not None

    def segment_tokens(self, segment: str) -> int:
        """Spliced token count of one segment (placeholder run length)."""
        if segment in ("frame", "face"):
            return (self.video_qformer.num_queries
                    if self.video_fusion_type == "qformer"
                    else self.num_video_query_token)
        if segment == "audio":
            return (self.audio_qformer.num_queries
                    if self.audio_fusion_type == "qformer"
                    else self.num_audio_query_token)
        if segment == "multi":
            return (self.multi_qformer.num_queries
                    if self.multi_fusion == "qformer" and self.multi_qformer
                    else self.num_multi_query_token)
        if segment == "image":
            return self.num_image_query_token
        raise KeyError(segment)


def config_from_dict(raw: dict) -> AffectGPTConfig:
    """Inverse of ``dataclasses.asdict`` (the ``config.json`` checkpoints
    carry)."""
    llm = dict(raw["llm"])
    if llm.get("mrope_section"):
        llm["mrope_section"] = tuple(llm["mrope_section"])
    kw = {k: v for k, v in raw.items()
          if k not in ("llm", "video_qformer", "audio_qformer", "multi_qformer")}
    return AffectGPTConfig(
        llm=LLMConfig(**llm),
        video_qformer=QFormerConfig(**raw["video_qformer"]),
        audio_qformer=QFormerConfig(**raw["audio_qformer"]),
        multi_qformer=(QFormerConfig(**raw["multi_qformer"])
                       if raw.get("multi_qformer") else None), **kw)


def _expand(tok, n: int):
    """(B, H) pooled vector -> (B, n, H) repeated tokens."""
    return tok[:, None, :].expand(tok.shape[0], n, tok.shape[1])


def _masked_mean(feats, mask):
    m = (torch.ones(feats.shape[:2], dtype=feats.dtype, device=feats.device)
         if mask is None else mask.to(feats.dtype))
    return (feats * m[..., None]).sum(1) / m.sum(1, keepdim=True).clamp(min=1.0)


def splice(embeds, tok, start):
    """Write tok (B, n, H) into embeds (B, S, H) at rows start[b] ..
    start[b] + n - 1 with ``jax.lax.dynamic_update_slice``'s index rule: a
    negative start counts from the end, then the start is clamped to
    [0, S - n] so the block fits. Out of place, differentiable in both."""
    B, S, H = embeds.shape
    n = tok.shape[1]
    start = start.to(embeds.device).long()
    start = torch.where(start < 0, start + S, start).clamp(0, S - n)
    pos = torch.arange(S, device=embeds.device)[None, :] - start[:, None]
    inside = (pos >= 0) & (pos < n)
    idx = pos.clamp(0, n - 1)[..., None].expand(B, S, H)
    return torch.where(inside[..., None],
                       tok.to(embeds.dtype).gather(1, idx), embeds)


class AffectGPT(nn.Module):
    def __init__(self, cfg: AffectGPTConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        H = c.llm.hidden_size

        # video branch (shared by the face and frame streams)
        vf = c.video_fusion_type
        if vf == "qformer":
            self.frame_position_embedding = nn.Parameter(
                torch.empty(c.max_video_frames, c.video_dim, device=device))
            self.video_qformer = QFormer(c.video_qformer, c.video_dim, device)
            v_out = c.video_qformer.hidden_size
        else:
            if vf == "attention":   # unnormalised linear scores
                self.video_attention_mlp = Linear(c.video_dim, 1, device=device)
            v_out = c.video_dim
        self.video_proj = Linear(v_out, H, device=device)

        af = c.audio_fusion_type
        if af == "qformer":
            self.audio_position_embedding = nn.Parameter(
                torch.empty(c.max_audio_frames, c.audio_dim, device=device))
            self.audio_qformer = QFormer(c.audio_qformer, c.audio_dim, device)
            a_out = c.audio_qformer.hidden_size
        else:
            if af == "attention":
                self.audio_attention_mlp = Linear(c.audio_dim, 1, device=device)
            a_out = c.audio_dim
        self.audio_proj = Linear(a_out, H, device=device)

        if c.has_multi:
            W = c.multi_width
            self.multi_video_embs = Linear(c.video_dim, W, device=device)
            self.multi_audio_embs = Linear(c.audio_dim, W, device=device)
            if c.multi_fusion == "qformer":
                if c.multi_qformer is None:
                    raise ValueError("multi_fusion='qformer' needs a "
                                     "multi_qformer config")
                self.multi_position_embedding = nn.Parameter(
                    torch.empty(c.multi_max_positions, W, device=device))
                self.multi_qformer = QFormer(c.multi_qformer, W, device)
                m_out = c.multi_qformer.hidden_size
            else:   # 2-way attention mix
                self.attention_mlp = Linear(2 * W, W, device=device)
                self.fc_att = Linear(W, 2, device=device)
                m_out = W
            self.multi_proj = Linear(m_out, H, device=device)

        if c.face_or_frame is not None and "image" in stream_plan(c.face_or_frame)[1]:
            self.image_proj = Linear(c.image_dim or c.video_dim, H, device=device)

        self.llm = LLM(c.llm, device)

    # fusion branches: each returns (llm tokens (B, n, H), raw hiddens)
    @staticmethod
    def _attention_pool(feats, mask, score_mlp):
        """sum_t h_t * s_t with s = Linear(D, 1)(h), not softmaxed; padded
        steps score 0."""
        scores = score_mlp(feats)
        if mask is not None:
            scores = scores * mask[..., None].to(scores.dtype)
        return (feats * scores).sum(1)

    def _video_branch(self, feats, mask):
        c = self.cfg
        feats = feats.detach()   # frozen-encoder features
        vf = c.video_fusion_type
        if vf == "qformer":
            x = feats + self.frame_position_embedding[: feats.shape[1]].to(feats.dtype)
            tok = self.video_proj(self.video_qformer(x, mask))
        elif vf == "mean":
            tok = _expand(self.video_proj(_masked_mean(feats, mask)),
                          c.num_video_query_token)
        else:
            tok = _expand(self.video_proj(self._attention_pool(
                feats, mask, self.video_attention_mlp)), c.num_video_query_token)
        return tok, feats

    def _audio_branch(self, feats, mask):
        c = self.cfg
        feats = feats.detach()
        af = c.audio_fusion_type
        if af == "qformer":
            x = feats + self.audio_position_embedding[: feats.shape[1]].to(feats.dtype)
            tok = self.audio_proj(self.audio_qformer(x, mask))
        elif af == "mean":
            tok = _expand(self.audio_proj(_masked_mean(feats, mask)),
                          c.num_audio_query_token)
        else:
            tok = _expand(self.audio_proj(self._attention_pool(
                feats, mask, self.audio_attention_mlp)), c.num_audio_query_token)
        return tok, feats

    def _multi_branch(self, video_hiddens, video_mask, audio_hiddens, audio_mask):
        c = self.cfg
        if c.multi_fusion == "qformer":
            v = self.multi_video_embs(video_hiddens)
            a = self.multi_audio_embs(audio_hiddens)
            x = torch.cat([v, a], 1)
            x = x + self.multi_position_embedding[: x.shape[1]].to(x.dtype)

            def ones(h):
                return torch.ones(h.shape[:2], dtype=torch.int32, device=h.device)

            m = torch.cat([video_mask if video_mask is not None else ones(v),
                           audio_mask if audio_mask is not None else ones(a)], 1)
            return self.multi_proj(self.multi_qformer(x, m))
        v = self.multi_video_embs(_masked_mean(video_hiddens, video_mask))
        a = self.multi_audio_embs(_masked_mean(audio_hiddens, audio_mask))
        att = self.fc_att(self.attention_mlp(torch.cat([v, a], -1)))  # no softmax
        fused = v * att[:, 0:1] + a * att[:, 1:2]
        return _expand(self.multi_proj(fused), c.num_multi_query_token)

    def _image_branch(self, feats):
        c = self.cfg
        feats = feats.detach()
        if c.image_fusion == "token":
            return self.image_proj(feats)
        return _expand(self.image_proj(feats.mean(1)), c.num_image_query_token)

    # legacy single-block contract (face_or_frame=None)
    @property
    def num_av_tokens(self) -> int:
        c = self.cfg
        if c.has_multi:
            return c.segment_tokens("multi")
        return c.segment_tokens("frame") + c.segment_tokens("audio")

    def encode_av(self, video_feats, audio_feats, video_mask=None, audio_mask=None):
        """Frozen-encoder features -> (B, P, H) AV tokens: the multi tokens
        when the multi branch is on, else video ++ audio."""
        v_tok, v_hid = self._video_branch(video_feats, video_mask)
        a_tok, a_hid = self._audio_branch(audio_feats, audio_mask)
        if self.cfg.has_multi:
            return self._multi_branch(v_hid, video_mask, a_hid, audio_mask)
        return torch.cat([v_tok, a_tok], 1)

    def _splice_all(self, embeds, batch):
        c = self.cfg
        if c.face_or_frame is None:
            av = self.encode_av(batch["video_feats"], batch["audio_feats"],
                                batch.get("video_mask"), batch.get("audio_mask"))
            return splice(embeds, av, batch["splice_start"])
        segments, needed = stream_plan(c.face_or_frame)
        toks, hiddens, masks = {}, {}, {}
        for s in ("face", "frame"):
            if s in needed:
                masks[s] = batch.get(f"{s}_mask")
                toks[s], hiddens[s] = self._video_branch(batch[f"{s}_feats"],
                                                         masks[s])
        if "audio" in needed:
            masks["audio"] = batch.get("audio_mask")
            toks["audio"], hiddens["audio"] = self._audio_branch(
                batch["audio_feats"], masks["audio"])
        if "image" in needed:
            toks["image"] = self._image_branch(batch["image_feats"])
        if "multi" in segments:
            v = "face" if c.face_or_frame.startswith("multiface") else "frame"
            toks["multi"] = self._multi_branch(hiddens[v], masks[v],
                                               hiddens["audio"], masks["audio"])
        for s in segments:
            embeds = splice(embeds, toks[s], batch[f"splice_{s}"])
        return embeds

    def forward(self, batch: dict):
        """Batch of tensors on the model's device (keys as in the JAX
        module). Returns (loss, logits), logits None with ``loss_chunk``."""
        embeds = self._splice_all(self.llm.embed(batch["input_ids"]), batch)
        if self.cfg.loss_chunk:
            return self.llm.loss(embeds, batch["labels"],
                                 batch.get("attention_mask"),
                                 chunk=self.cfg.loss_chunk), None
        logits = self.llm(embeds, batch.get("attention_mask"))
        return lm_loss(logits, batch["labels"]), logits

    def generate_step_embeds(self, batch: dict):
        """Spliced prompt embeddings for autoregressive decoding."""
        return self._splice_all(self.llm.embed(batch["input_ids"]), batch)


# reference frozen_* config keys -> parameter subtrees
FROZEN_KEY_MAP = {
    "frozen_llm": ("llm",),                       # includes LoRA
    "frozen_video_Qformer": ("video_qformer", "frame_position_embedding",
                             "video_attention_mlp"),
    "frozen_audio_Qformer": ("audio_qformer", "audio_position_embedding",
                             "audio_attention_mlp"),
    "frozen_multi_Qformer": ("multi_qformer", "multi_position_embedding",
                             "attention_mlp", "fc_att",
                             "multi_video_embs", "multi_audio_embs"),
    "frozen_video_proj": ("video_proj",),
    "frozen_audio_proj": ("audio_proj",),
    "frozen_multi_llama_proj": ("multi_proj",),
    "frozen_image_proj": ("image_proj",),
}


def frozen_components(cfg: dict) -> tuple:
    """Reference frozen_* yaml keys -> parameter subtrees to freeze."""
    out = []
    for key, subtrees in FROZEN_KEY_MAP.items():
        if cfg.get(key):
            out.extend(subtrees)
    return tuple(out)


def is_trainable(name: str, frozen: tuple = ()) -> bool:
    """The JAX ``trainable_labels`` rule for one parameter name: Q-Formers,
    projections, position embeddings, fusion MLPs and LoRA train; the LLM
    base is frozen; ``frozen`` freezes more top-level subtrees ('llm' there
    freezes the LoRA deltas too)."""
    parts = name.split(".")
    if parts[0] in frozen:
        return False
    if parts[-1] in ("lora_A", "lora_B"):
        return True
    return parts[0] != "llm"


def set_trainable(model: AffectGPT, frozen: tuple = ()) -> None:
    """Set ``requires_grad`` by :func:`is_trainable`: frozen parameters get no
    gradient at all."""
    for name, p in model.named_parameters():
        p.requires_grad_(is_trainable(name, frozen))


def state_dict_from_flax(cfg: AffectGPTConfig, params) -> dict:
    """The JAX package's whole ``AffectGPT`` param tree -> this module's
    state dict (the LLM through :func:`llm.state_dict_from_flax`)."""
    sd = {}
    for name, sub in params.items():
        if name == "llm":
            sd.update({f"llm.{k}": v for k, v in
                       _llm.state_dict_from_flax(cfg.llm, sub).items()})
        else:
            sd.update(_qformer.state_dict_from_flax({name: sub}))
    return sd


def build(cfg: AffectGPTConfig, device="cuda", seed: int | None = 0) -> AffectGPT:
    """An :class:`AffectGPT` on ``device`` with parameters drawn by
    :func:`llm.init_weights` from a generator seeded with ``seed`` on that
    device (None leaves them uninitialised, for a state dict to fill).
    ``device`` is the card unless the caller asks for ``"cpu"``; a host
    without a card raises rather than falling back to the CPU."""
    dev = resolve_device(device, fp32=False)   # TF32 stays as the caller set it
    model = AffectGPT(cfg, dev)
    if seed is not None:
        _llm.init_weights(model, torch.Generator(dev).manual_seed(seed))
    return model

