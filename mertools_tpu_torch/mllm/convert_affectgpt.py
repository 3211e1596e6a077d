"""Loader of the reference's trained AffectGPT checkpoints — port of
``mertools_tpu/mllm/convert_affectgpt.py``.

The reference saves trainable-only state dicts per epoch
(``runner_base.py:594-638``: Q-Formers, position embeddings, fusion MLPs,
LLM projections and peft LoRA deltas; the frozen encoders and LLM base come
from their own checkpoints). :func:`convert_affectgpt_checkpoint` maps such a
state dict onto the port's :class:`~.affectgpt.AffectGPT` state-dict keys and
infers the config; :func:`apply_checkpoint` loads it over a built model.

Branch fusion types and widths are read from the key set (affectgpt.py:
142-299 creates parameters per fusion type); ``face_or_frame`` is not in the
weights (it is the checkpoint's ``config``) and must be given.
"""

from __future__ import annotations

import dataclasses

from .qformer import _tensor, from_blip2_qformer


def _linear(sd, key, name) -> dict:
    out = {f"{name}.weight": _tensor(sd[f"{key}.weight"])}
    if f"{key}.bias" in sd:
        out[f"{name}.bias"] = _tensor(sd[f"{key}.bias"])
    return out


def _qformer(sd, prefix, num_heads, name):
    """'video_Qformer.*' + 'video_query_tokens' -> (cfg, state dict under
    ``name``), by the BLIP-2 naming (init_video_Qformer builds a
    BertLMHeadModel with cross_attention_freq=1, affectgpt.py:24-37)."""
    sub = {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}
    qt = f"{prefix.split('_')[0]}_query_tokens"
    if qt in sd:
        sub["query_tokens"] = sd[qt]
    cfg, qsd = from_blip2_qformer(sub, prefix="bert.", attn_inner="self",
                                  num_heads=num_heads)
    return cfg, {f"{name}.{k}": v for k, v in qsd.items()}


def _branch_fusion(sd, name):
    """'video' | 'audio' | 'multi' -> the fusion type the state dict holds."""
    if any(k.startswith(f"{name}_Qformer.") for k in sd):
        return "qformer"
    if name == "multi":
        return "attention" if "attention_mlp.weight" in sd else None
    return "attention" if f"{name}_attention_mlp.weight" in sd else "mean"


_PROJS = (("q_proj", "self_attn"), ("k_proj", "self_attn"), ("v_proj", "self_attn"),
          ("o_proj", "self_attn"), ("gate_proj", "mlp"), ("up_proj", "mlp"),
          ("down_proj", "mlp"))


def convert_lora(sd, num_layers: int) -> dict:
    """peft LoRA deltas -> the port's ``llm.layers.{i}.{group}.{proj}.lora_A``
    (r, in) / ``lora_B`` (out, r), the peft orientation (keys may carry an
    adapter segment, ``lora_A.default.weight``)."""
    out = {}

    def find(layer, proj, ab):
        for key in (f"lora_{ab}.weight", f"lora_{ab}.default.weight"):
            for stem in sd:
                if f"layers.{layer}." in stem and f"{proj}.{key}" in stem:
                    return _tensor(sd[stem])
        return None

    for i in range(num_layers):
        for proj, group in _PROJS:
            a, b = find(i, proj, "A"), find(i, proj, "B")
            if a is not None and b is not None:
                out[f"llm.layers.{i}.{group}.{proj}.lora_A"] = a
                out[f"llm.layers.{i}.{group}.{proj}.lora_B"] = b
    return out


def convert_affectgpt_checkpoint(sd: dict, llm_cfg, face_or_frame: str,
                                 num_heads: int = 12, lora_alpha: float = 32.0):
    """Reference trainable-only state dict -> (AffectGPTConfig, state dict
    of the port's AffectGPT keys). ``llm_cfg`` is the base LLM's config;
    ``lora_alpha`` is the reference's hard-coded 32 (affectgpt.py:116), set
    on the returned config with the rank the deltas carry."""
    from .affectgpt import AffectGPTConfig

    out: dict = {}
    kw: dict = {"face_or_frame": face_or_frame}

    vf = _branch_fusion(sd, "video")
    kw["video_fusion"] = vf
    vq_cfg = None
    if vf == "qformer":
        pos = _tensor(sd["video_frame_position_embedding.weight"])
        out["frame_position_embedding"] = pos
        kw["max_video_frames"], kw["video_dim"] = pos.shape
        vq_cfg, qsd = _qformer(sd, "video_Qformer", num_heads, "video_qformer")
        out.update(qsd)
    else:
        if vf == "attention":
            out.update(_linear(sd, "video_attention_mlp", "video_attention_mlp"))
        kw["video_dim"] = sd["affectgpt_proj.weight"].shape[1]
    out.update(_linear(sd, "affectgpt_proj", "video_proj"))

    af = _branch_fusion(sd, "audio")
    kw["audio_fusion"] = af
    aq_cfg = None
    if af == "qformer":
        pos = _tensor(sd["audio_position_embedding.weight"])
        out["audio_position_embedding"] = pos
        kw["max_audio_frames"], kw["audio_dim"] = pos.shape
        aq_cfg, qsd = _qformer(sd, "audio_Qformer", num_heads, "audio_qformer")
        out.update(qsd)
    else:
        if af == "attention":
            out.update(_linear(sd, "audio_attention_mlp", "audio_attention_mlp"))
        kw["audio_dim"] = sd["audio_llama_proj.weight"].shape[1]
    out.update(_linear(sd, "audio_llama_proj", "audio_proj"))

    mf = _branch_fusion(sd, "multi")
    mq_cfg = None
    if mf is not None and "multi_llama_proj.weight" in sd:
        kw["multi_fusion"] = mf
        out.update(_linear(sd, "multi_video_embs", "multi_video_embs"))
        out.update(_linear(sd, "multi_audio_embs", "multi_audio_embs"))
        if mf == "qformer":
            pos = _tensor(sd["multi_position_embedding.weight"])
            out["multi_position_embedding"] = pos
            kw["multi_max_positions"] = pos.shape[0]
            mq_cfg, qsd = _qformer(sd, "multi_Qformer", num_heads, "multi_qformer")
            out.update(qsd)
        else:
            out.update(_linear(sd, "attention_mlp", "attention_mlp"))
            out.update(_linear(sd, "fc_att", "fc_att"))
        out.update(_linear(sd, "multi_llama_proj", "multi_proj"))

    if "image_llama_proj.weight" in sd:
        out.update(_linear(sd, "image_llama_proj", "image_proj"))

    lora = convert_lora(sd, llm_cfg.num_layers)
    if lora:
        r = next(iter(lora.values())).shape[0]
        llm_cfg = dataclasses.replace(llm_cfg, lora_r=r, lora_alpha=lora_alpha)
    out.update(lora)

    cfg = AffectGPTConfig(
        llm=llm_cfg,
        video_qformer=vq_cfg or AffectGPTConfig().video_qformer,
        audio_qformer=aq_cfg or AffectGPTConfig().audio_qformer,
        multi_qformer=mq_cfg, **kw)
    return cfg, out


def apply_checkpoint(model, state: dict):
    """Load a converted state dict over ``model`` (built from the returned
    config) in place, strict=False as the reference's staged checkpoint
    loads are (runner_base.py:659-684): the parameters it lacks keep their
    values; one the model does not have raises."""
    missing, unexpected = model.load_state_dict(state, strict=False)
    if unexpected:
        raise KeyError(f"converted checkpoint has keys the model lacks: {unexpected[:5]}")
    return model
