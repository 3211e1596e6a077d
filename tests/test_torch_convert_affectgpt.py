"""The port's loaders of reference checkpoints against the JAX converters:
``convert_affectgpt_checkpoint`` (attention fusion everywhere with peft LoRA
in both key styles, and Q-Former fusion everywhere) infers the JAX config
and gives, over the same initial weights, the state dict of the JAX
converted tree; the spliced prompt embeddings agree; ``from_blip2_qformer``
loads an HF ``Blip2QFormerModel`` whose output the port's QFormer
reproduces."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mertools_tpu.mllm import AffectGPT as JAffectGPT
from mertools_tpu.mllm import convert_affectgpt as jconv
from mertools_tpu.mllm.qformer import from_blip2_qformer as j_blip2
from mertools_tpu_torch.mllm import affectgpt as ta
from mertools_tpu_torch.mllm import convert_affectgpt as tconv
from mertools_tpu_torch.mllm import llm as tl
from mertools_tpu_torch.mllm import qformer as tq
from test_convert_affectgpt import _attention_sd, _fake_qformer_sd, _llm_cfg

torch.set_num_threads(1)


def _stream_batch(rng, Dv, Da, B=2, S=24, starts=(1, 6, 10)):
    return {"face_feats": rng.normal(size=(B, 5, Dv)).astype(np.float32),
            "face_mask": np.ones((B, 5), np.int32),
            "audio_feats": rng.normal(size=(B, 4, Da)).astype(np.float32),
            "audio_mask": np.ones((B, 4), np.int32),
            "input_ids": rng.integers(3, 64, size=(B, S)).astype(np.int32),
            "attention_mask": np.ones((B, S), np.int32),
            "labels": np.full((B, S), -100, np.int64),
            "splice_multi": np.full(B, starts[0], np.int32),
            "splice_audio": np.full(B, starts[1], np.int32),
            "splice_face": np.full(B, starts[2], np.int32)}


def _qformer_sd(rng):
    Dv, Da, H, H_llm = 12, 10, 16, 32
    sd = {"video_frame_position_embedding.weight": rng.normal(size=(32, Dv)),
          "audio_position_embedding.weight": rng.normal(size=(8, Da)),
          "multi_position_embedding.weight": rng.normal(size=(264, Dv)),
          "affectgpt_proj.weight": rng.normal(size=(H_llm, H)),
          "affectgpt_proj.bias": np.zeros(H_llm),
          "audio_llama_proj.weight": rng.normal(size=(H_llm, H)),
          "audio_llama_proj.bias": np.zeros(H_llm),
          "multi_llama_proj.weight": rng.normal(size=(H_llm, H)),
          "multi_llama_proj.bias": np.zeros(H_llm),
          "multi_video_embs.weight": rng.normal(size=(Dv, Dv)),
          "multi_video_embs.bias": np.zeros(Dv),
          "multi_audio_embs.weight": rng.normal(size=(Dv, Da)),
          "multi_audio_embs.bias": np.zeros(Dv)}
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    sd.update(_fake_qformer_sd(rng, "video_Qformer", 2, H, 32, Dv, 4))
    sd.update(_fake_qformer_sd(rng, "audio_Qformer", 2, H, 32, Da, 2))
    sd.update(_fake_qformer_sd(rng, "multi_Qformer", 2, H, 32, Dv, 3))
    return sd, Dv, Da


CASES = {"attention": lambda rng: (_attention_sd(rng), 12, 10),
         "attention_peft_default": lambda rng: (_attention_sd(rng, peft_default=True), 12, 10),
         "qformer": _qformer_sd}


@pytest.mark.parametrize("case", list(CASES))
def test_converter_gives_the_jax_converted_weights(case):
    rng = np.random.default_rng(0)
    sd, Dv, Da = CASES[case](rng)
    heads = 2 if case == "qformer" else 12
    jcfg, glue, lora = jconv.convert_affectgpt_checkpoint(
        sd, _llm_cfg(), "multiface_audio_face_text", num_heads=heads)
    tllm = tl.LLMConfig(**dataclasses.asdict(_llm_cfg()))
    tcfg, state = tconv.convert_affectgpt_checkpoint(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tllm,
        "multiface_audio_face_text", num_heads=heads)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)

    batch = _stream_batch(rng, Dv, Da)
    jmodel = JAffectGPT(jcfg)
    init = jmodel.init(jax.random.PRNGKey(0), batch)["params"]
    params = jconv.apply_checkpoint(init, glue, lora)
    port = ta.AffectGPT(tcfg)
    port.load_state_dict(ta.state_dict_from_flax(tcfg, init))
    tconv.apply_checkpoint(port, state)
    want = ta.state_dict_from_flax(tcfg, params)
    for k, v in port.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert len(state) > 10 and set(state) <= set(want)

    jemb = np.asarray(jmodel.apply({"params": params}, batch,
                                   method=JAffectGPT.generate_step_embeds))
    with torch.no_grad():
        temb = port.generate_step_embeds({k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.abs(temb.numpy() - jemb).max() <= 1e-4 * np.abs(jemb).max()


def test_a_key_the_model_lacks_raises():
    rng = np.random.default_rng(1)
    sd, _, _ = CASES["attention"](rng)
    tcfg, state = tconv.convert_affectgpt_checkpoint(
        sd, tl.LLMConfig(**dataclasses.asdict(_llm_cfg())), "multiface_audio_face_text")
    port = ta.AffectGPT(tcfg)
    with pytest.raises(KeyError, match="lacks"):
        tconv.apply_checkpoint(port, {**state, "not_a_param": torch.zeros(1)})


@pytest.mark.parametrize("freq", [1, 2])
def test_blip2_qformer_loader_matches_hf_and_jax(freq):
    from transformers import Blip2QFormerConfig, Blip2QFormerModel

    hf_cfg = Blip2QFormerConfig(vocab_size=30, hidden_size=24, num_hidden_layers=2,
                                num_attention_heads=2, intermediate_size=48,
                                encoder_hidden_size=30, cross_attention_frequency=freq)
    torch.manual_seed(0)
    model = Blip2QFormerModel(hf_cfg).eval()
    rng = np.random.default_rng(2)
    B, nq, T = 2, 4, 5
    qt = rng.normal(size=(1, nq, 24)).astype(np.float32) * 0.5
    enc = rng.normal(size=(B, T, 30)).astype(np.float32)
    enc_mask = np.ones((B, T), np.int64)
    enc_mask[1, 3:] = 0
    with torch.no_grad():
        ref = model(query_embeds=torch.from_numpy(qt).expand(B, -1, -1),
                    encoder_hidden_states=torch.from_numpy(enc),
                    encoder_attention_mask=torch.from_numpy(enc_mask)
                    ).last_hidden_state.numpy()
    sd = dict(model.state_dict())
    sd["query_tokens"] = torch.from_numpy(qt)
    cfg, state = tq.from_blip2_qformer(sd, prefix="", attn_inner="attention", num_heads=2)
    jcfg, jparams = j_blip2(sd, prefix="", attn_inner="attention", num_heads=2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    qf = tq.QFormer(cfg, state["cross_attn_0.k.weight"].shape[1])
    qf.load_state_dict(state, strict=True)
    jsd = tq.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    for k, v in state.items():
        assert torch.equal(v, jsd[k]), k
    with torch.no_grad():
        out = qf(torch.from_numpy(enc), torch.from_numpy(enc_mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=3e-5)
