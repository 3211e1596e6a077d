"""The port's AffectGPT (mertools_tpu_torch/mllm/affectgpt.py) against the JAX
module on the same weights (``state_dict_from_flax`` of the whole tree): the
loss and the gradient of every trainable leaf against ``jax.value_and_grad``,
for the legacy single-block splice (Q-Former fusion) and the reference's
best-setup multi-stream mode (``multiface_audio_face_text``, attention
fusion everywhere); the frozen base gets no gradient; the splice clamps its
start as ``dynamic_update_slice`` does; the trainable set is the JAX
``trainable_labels`` set."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.mllm import affectgpt as ja
from mertools_tpu.mllm.llm import LLMConfig
from mertools_tpu.mllm.qformer import QFormerConfig
from mertools_tpu_torch.mllm import affectgpt as ta

torch.set_num_threads(1)

LOSS_TOL = 3e-4   # relative, fp32 on both sides
GRAD_TOL = 1e-3   # max |port - jax| / max |jax| per leaf, plus
GRAD_ATOL = 1e-6  # for leaves whose gradient is zero in exact arithmetic
                  # (a key bias under softmax): rounding noise on both sides

QF = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)
LLM_CFG = LLMConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                    num_kv_heads=2, intermediate_size=64, lora_r=2)
CONFIGS = {
    "legacy": ja.AffectGPTConfig(
        llm=LLM_CFG, video_qformer=QFormerConfig(num_queries=4, **QF),
        audio_qformer=QFormerConfig(num_queries=2, **QF),
        video_dim=12, audio_dim=10, max_video_frames=6, max_audio_frames=6),
    "multiface_audio_face_text": ja.AffectGPTConfig(
        llm=LLM_CFG, video_dim=12, audio_dim=10, fusion="attention",
        multi_fusion="attention", num_video_query_token=2,
        num_audio_query_token=3, num_multi_query_token=2,
        face_or_frame="multiface_audio_face_text", loss_chunk=5),
}
S = 16


def _batch(name, rng, B=4):
    mask = np.ones((B, S), np.int32)
    mask[2, 12:] = 0
    labels = rng.integers(0, 64, size=(B, S))
    labels[:, :9] = -100
    labels[mask == 0] = -100
    batch = {"input_ids": rng.integers(1, 64, size=(B, S)).astype(np.int32),
             "attention_mask": mask, "labels": labels}
    vmask = np.ones((B, 6), np.int32)
    vmask[1, 3:] = 0
    amask = np.ones((B, 5), np.int32)
    amask[3, 2:] = 0
    if name == "legacy":
        batch.update(video_feats=rng.normal(size=(B, 6, 12)).astype(np.float32),
                     audio_feats=rng.normal(size=(B, 5, 10)).astype(np.float32),
                     video_mask=vmask, audio_mask=amask,
                     # 14 and 15 lie past S - 6: the block is clamped to fit
                     splice_start=np.array([1, 3, 14, 15], np.int32))
    else:
        batch.update(face_feats=rng.normal(size=(B, 6, 12)).astype(np.float32),
                     audio_feats=rng.normal(size=(B, 5, 10)).astype(np.float32),
                     face_mask=vmask, audio_mask=amask,
                     splice_multi=np.array([1, 1, 2, 0], np.int32),
                     splice_audio=np.array([4, 5, 4, 3], np.int32),
                     splice_face=np.array([8, 9, 15, 7], np.int32))
    return batch


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    name = request.param
    cfg = CONFIGS[name]
    batch = _batch(name, np.random.default_rng(0))
    model = ja.AffectGPT(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(   # LoRA B non-zero
        lambda p, leaf: (jnp.asarray(rng.normal(size=leaf.shape) * 0.05, jnp.float32)
                         if getattr(p[-1], "key", None) == "lora_b" else leaf),
        params)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.apply({"params": p}, batch)[0]))(params)
    labels = ja.trainable_labels(params)
    tcfg = ta.config_from_dict(dataclasses.asdict(cfg))
    port = ta.AffectGPT(tcfg)
    port.load_state_dict(ta.state_dict_from_flax(tcfg, params), strict=True)
    ta.set_trainable(port)
    return (name, tcfg, port, batch, float(loss),
            ta.state_dict_from_flax(tcfg, grads),
            ta.state_dict_from_flax(tcfg, jax.tree_util.tree_map(
                lambda lab: np.float32(lab == "train"), labels)))


def test_loss_and_trainable_gradients_match_jax(case):
    name, _, port, batch, loss, grads, trainable = case
    port.zero_grad(set_to_none=True)
    got, logits = port({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    assert (logits is None) == (name != "legacy")
    assert abs(got.item() - loss) <= LOSS_TOL * abs(loss)
    got.backward()
    checked = 0
    for n, p in port.named_parameters():
        assert bool(trainable[n]) == p.requires_grad, n
        if not p.requires_grad:
            assert p.grad is None, n     # the frozen base gets no gradient
            continue
        want = grads[n].numpy()
        scale = np.abs(want).max()
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= GRAD_TOL * scale + GRAD_ATOL, (n, err, scale)
        checked += 1
    assert checked > 10


def test_frozen_components_freeze_their_subtrees(case):
    name, tcfg, port, *_ = case
    frozen = ta.frozen_components({"frozen_audio_proj": True, "frozen_llm": True,
                                   "frozen_video_Qformer": True})
    ta.set_trainable(port, frozen)
    try:
        names = {n for n, p in port.named_parameters() if p.requires_grad}
        assert not any(n.startswith(("llm.", "audio_proj.")) for n in names)
        assert "video_proj.weight" in names
        if name == "legacy":
            assert not any(n.startswith("video_qformer.") for n in names)
    finally:
        ta.set_trainable(port)


@pytest.mark.parametrize("starts", [[0, 3, 10, 16], [-2, 15, 9, 100]])
def test_splice_clamps_like_dynamic_update_slice(starts):
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(4, S, 8)).astype(np.float32)
    tok = rng.normal(size=(4, 6, 8)).astype(np.float32)
    st = np.array(starts, np.int32)
    want = jax.vmap(lambda e, a, s: jax.lax.dynamic_update_slice(e, a, (s, 0)))(
        emb, tok, st)
    got = ta.splice(torch.from_numpy(emb), torch.from_numpy(tok),
                    torch.from_numpy(st))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_step_embeds_and_stream_plan(case):
    name, tcfg, port, batch, *_ = case
    with torch.no_grad():
        emb = port.generate_step_embeds(
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    assert emb.shape == (4, S, 32)
    for mode in ja.SEGMENTS_BY_MODE:
        assert ta.stream_plan(mode) == ja.stream_plan(mode)
        c = dataclasses.replace(CONFIGS[name], face_or_frame=mode)
        tc = dataclasses.replace(tcfg, face_or_frame=mode)
        for seg in ta.SEGMENTS_BY_MODE[mode]:
            assert tc.segment_tokens(seg) == c.segment_tokens(seg)


def test_build_defaults_to_the_card(monkeypatch):
    """build() builds and initialises on the card unless asked for the CPU;
    on a host without a card the default raises instead of falling back."""
    tcfg = ta.config_from_dict(dataclasses.asdict(CONFIGS["legacy"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.build(tcfg)
    m = ta.build(tcfg, "cpu", seed=3)
    assert {p.device.type for p in m.parameters()} == {"cpu"}
    again = ta.build(tcfg, "cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(), again.parameters()))
