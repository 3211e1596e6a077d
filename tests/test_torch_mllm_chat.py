"""The port's ``Chat`` and ``ChatSession`` (mertools_tpu_torch/mllm/chat.py)
against the JAX classes on the same AffectGPT weights
(``affectgpt.state_dict_from_flax``): the legacy single-block splice and the
best-setup multi-stream mode answer with the JAX texts (greedy, with and
without kv_int8), a session carries its history as JAX's does, the AV
features reach the spliced prompt, and the EOS falls back to SEP, PAD, 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.mllm import affectgpt as ja
from mertools_tpu.mllm import chat as jc
from mertools_tpu.mllm.llm import LLMConfig
from mertools_tpu.mllm.qformer import QFormerConfig
from mertools_tpu_torch.mllm import affectgpt as ta
from mertools_tpu_torch.mllm import chat as tc

torch.set_num_threads(1)

QF = dict(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32)
LLM_CFG = LLMConfig(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
                    num_kv_heads=2, intermediate_size=64, lora_r=2)
CONFIGS = {
    "legacy": ja.AffectGPTConfig(
        llm=LLM_CFG, video_qformer=QFormerConfig(num_queries=4, **QF),
        audio_qformer=QFormerConfig(num_queries=2, **QF),
        video_dim=12, audio_dim=10, max_video_frames=8, max_audio_frames=8),
    "multiface_audio_face_text": ja.AffectGPTConfig(
        llm=LLM_CFG, video_dim=12, audio_dim=10, fusion="attention",
        multi_fusion="attention", num_video_query_token=2,
        num_audio_query_token=3, num_multi_query_token=2,
        max_video_frames=8, max_audio_frames=8,
        face_or_frame="multiface_audio_face_text"),
}


class WordTok:
    """Deterministic word tokenizer over a closed vocab, EOS 2."""

    eos_token_id = 2

    def encode(self, text, add_special_tokens=True):
        return ([1] if add_special_tokens else []) + [
            3 + sum(map(ord, w)) % 93 for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{i}" for i in ids if i != self.eos_token_id)


def _init_batch(name, B=2, S=48):
    batch = {"input_ids": np.zeros((B, S), np.int32),
             "attention_mask": np.ones((B, S), np.int32),
             "labels": np.full((B, S), -100, np.int64)}
    if name == "legacy":
        batch.update(video_feats=np.zeros((B, 8, 12), np.float32),
                     audio_feats=np.zeros((B, 8, 10), np.float32),
                     splice_start=np.zeros(B, np.int32))
    else:
        batch.update(face_feats=np.zeros((B, 8, 12), np.float32),
                     audio_feats=np.zeros((B, 8, 10), np.float32),
                     **{f"splice_{s}": np.zeros(B, np.int32)
                        for s in ("multi", "audio", "face")})
    return batch


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    name = request.param
    cfg = CONFIGS[name]
    model = ja.AffectGPT(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), _init_batch(name))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(   # LoRA B non-zero
        lambda p, leaf: (jnp.asarray(rng.normal(size=leaf.shape) * 0.1, jnp.float32)
                         if getattr(p[-1], "key", None) == "lora_b" else leaf),
        params)
    tcfg = ta.config_from_dict(dataclasses.asdict(cfg))
    port = ta.AffectGPT(tcfg)
    port.load_state_dict(ta.state_dict_from_flax(tcfg, params), strict=True)
    return name, model, params, port.eval()


def _samples(name, seed=2):
    rng = np.random.default_rng(seed)
    key = "video_feats" if name == "legacy" else "face_feats"
    return [{key: rng.normal(size=(t, 12)).astype(np.float32),
             "audio_feats": rng.normal(size=(a, 10)).astype(np.float32),
             "subtitle": sub}
            for t, a, sub in ((5, 4, "i am fine"), (8, 6, ""), (3, 7, "so so"))]


@pytest.mark.parametrize("kv_int8", [False, True])
def test_answer_batch_equals_jax(case, kv_int8):
    name, model, params, port = case
    samples = _samples(name)
    kw = dict(max_new_tokens=6, temperature=0.0, kv_int8=kv_int8)
    want = jc.Chat(model, params, WordTok(), **kw).answer_batch(samples)
    got = tc.Chat(port, WordTok(), device="cpu", **kw).answer_batch(samples)
    assert got == want
    assert all(isinstance(a, str) for a in got)


def test_session_history_equals_jax(case):
    name, model, params, port = case
    sample = _samples(name, seed=3)[0]
    js = jc.ChatSession(jc.Chat(model, params, WordTok(), max_new_tokens=4), sample)
    ts = tc.ChatSession(tc.Chat(port, WordTok(), max_new_tokens=4, device="cpu"), sample)
    for q in ("how does she feel?", "why?"):
        assert ts.ask(q) == js.ask(q)
    assert ts.history == js.history and len(ts.history) == 2


def test_av_features_reach_the_spliced_prompt(case):
    """Two clips under one prompt: the placeholder runs differ, every other
    position is the same."""
    name, _, _, port = case
    a, b = _samples(name, 4)[:2]
    cfg = port.cfg
    if name == "legacy":
        chat = tc.Chat(port, WordTok(), device="cpu")
        ids, _, starts = chat._encode_prompts([("same words", None)] * 2)
        batch = {"video_feats": np.stack([a["video_feats"][:5], b["video_feats"][:5]]),
                 "audio_feats": np.stack([a["audio_feats"][:4], b["audio_feats"][:4]]),
                 "input_ids": ids, "splice_start": starts}
        runs = [(int(starts[0]), port.num_av_tokens)]
    else:
        row, st = tc.encode_stream_prompt(WordTok(), cfg, "same words", "q")
        batch = {"face_feats": np.stack([a["face_feats"][:5], b["face_feats"][:5]]),
                 "audio_feats": np.stack([a["audio_feats"][:4], b["audio_feats"][:4]]),
                 "input_ids": np.array([row, row], np.int64),
                 **{f"splice_{g}": np.array([v, v], np.int64) for g, v in st.items()}}
        runs = [(v, cfg.segment_tokens(g)) for g, v in st.items()]
    with torch.no_grad():
        e = port.generate_step_embeds({k: torch.from_numpy(v) for k, v in batch.items()})
    inside = np.zeros(e.shape[1], bool)
    for s0, n in runs:
        inside[s0: s0 + n] = True
        assert not torch.allclose(e[0, s0: s0 + n], e[1, s0: s0 + n])
    assert torch.equal(e[0, ~inside], e[1, ~inside])


def test_eos_falls_back_to_sep_then_pad_then_zero(case):
    _, _, _, port = case

    class Tok(WordTok):
        eos_token_id = None

    for attrs, want in (({"sep_token_id": 5, "pad_token_id": 6}, 5),
                        ({"pad_token_id": 0}, 0), ({"pad_token_id": 7}, 7), ({}, 0)):
        tok = Tok()
        for k, v in attrs.items():
            setattr(tok, k, v)
        assert tc.Chat(port, tok, device="cpu").eos == want
    assert tc.Chat(port, WordTok(), eos_token_id=9, device="cpu").eos == 9


def test_prompt_past_max_len_raises(case):
    name, _, _, port = case
    chat = tc.Chat(port, WordTok(), max_len=20, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        chat.answer_batch(_samples(name)[:1])


def test_chat_needs_a_card_unless_asked_for_the_cpu(case, monkeypatch):
    _, _, _, port = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.Chat(port, WordTok())
