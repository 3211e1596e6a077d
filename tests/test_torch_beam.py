"""The port's beam search (mertools_tpu_torch/mllm/beam.py) against the JAX
module on the same weights (an HF tiny Llama through both packages'
converters): greedy beams at three length penalties, the EOS fold path,
embedding prompts, the Otter processors, ragged batches and kv_int8 give
the JAX beams, and beam *sampling* with the same seed draws the same beams;
the numpy ``HFBeam`` is the JAX one step for step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.mllm import beam as jb
from mertools_tpu.mllm.llm import LLMConfig as JConfig
from mertools_tpu.mllm.llm import convert_torch_state
from mertools_tpu_torch.mllm import beam as tb
from mertools_tpu_torch.mllm import llm as tl

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      intermediate_size=64, max_position_embeddings=256,
                      attention_dropout=0.0, eos_token_id=2, pad_token_id=0)
    torch.manual_seed(11)
    sd = LlamaForCausalLM(cfg).eval().state_dict()
    jcfg = JConfig.from_hf(cfg)
    params = convert_torch_state(jcfg, sd)
    model = tl.LLM(tl.LLMConfig.from_hf(cfg.to_dict()))
    missing, unexpected = model.load_state_dict(tl.load_hf_state_dict(sd), strict=False)
    assert not missing and not unexpected
    return jcfg, params, model.eval()


def _run(both, ids=None, emb=None, mask=None, **kw):
    jcfg, params, model = both
    table = np.asarray(params["embed_tokens"]["embedding"])
    if emb is None:
        emb, mask = table[ids], np.ones(ids.shape, np.int32)
        kw.setdefault("prompt_token_ids", [list(map(int, r)) for r in ids])
    want = jb.beam_generate(jcfg, params, jnp.asarray(emb), jnp.asarray(mask), **kw)
    got = tb.beam_generate(model, torch.from_numpy(emb), torch.from_numpy(mask), **kw)
    return got, want


@pytest.mark.parametrize("length_penalty", [1.0, 2.0, 0.0])
def test_greedy_beams_equal_jax(both, length_penalty):
    ids = np.random.default_rng(0).integers(3, 64, size=(2, 6))
    got, want = _run(both, ids, num_beams=3, max_new_tokens=10, eos_token_id=2,
                     length_penalty=length_penalty)
    assert got == want


def test_eos_fold_path_equals_jax(both):
    """An EOS id the beams meet mid-stream: finished hypotheses fold in."""
    ids = np.random.default_rng(1).integers(3, 64, size=(1, 5))
    probe, _ = _run(both, ids, num_beams=3, max_new_tokens=6, eos_token_id=63)
    eos = int(probe[0][2])
    got, want = _run(both, ids, num_beams=3, max_new_tokens=10, eos_token_id=eos)
    assert got == want and any(eos in r for r in got)


def test_embedding_prompts_and_ragged_rows_equal_jax(both):
    _, params, _ = both
    table = np.asarray(params["embed_tokens"]["embedding"])
    rng = np.random.default_rng(4)
    rows = [rng.integers(3, 64, size=n) for n in (4, 9)]
    emb = np.zeros((2, 9, table.shape[1]), np.float32)
    mask = np.zeros((2, 9), np.int32)
    for i, r in enumerate(rows):
        emb[i, : len(r)], mask[i, : len(r)] = table[r], 1
    got, want = _run(both, emb=emb, mask=mask, num_beams=4, max_new_tokens=8,
                     eos_token_id=2)
    assert got == want
    got8, want8 = _run(both, emb=emb, mask=mask, num_beams=3, max_new_tokens=8,
                       eos_token_id=2, kv_int8=True)
    assert got8 == want8


def test_otter_processors_equal_jax(both):
    from mertools_tpu.preference.otter import _process_logits

    ids = np.random.default_rng(3).integers(3, 64, size=(1, 6))
    probe, _ = _run(both, ids, num_beams=3, max_new_tokens=4, eos_token_id=2)
    bad = [[probe[0][0]], [probe[0][1]], [probe[0][2], probe[0][3]]]
    got, want = _run(both, ids, num_beams=3, max_new_tokens=12, eos_token_id=2,
                     process_fn=lambda seq, lp: _process_logits(lp, list(seq), bad, 3))
    assert got == want
    assert bad[0][0] not in got[0] and bad[1][0] not in got[0]


@pytest.mark.parametrize("seed", [0, 123])
def test_beam_sampling_with_the_same_seed_equals_jax(both, seed):
    """SALMONN's protocol (4 beams, do_sample, top_p 0.9): the numpy
    generator draws the same beams from the same logits."""
    ids = np.random.default_rng(5).integers(3, 64, size=(2, 5))
    got, want = _run(both, ids, num_beams=4, max_new_tokens=8, eos_token_id=2,
                     do_sample=True, temperature=1.0, top_p=0.9, min_new_tokens=1,
                     seed=seed, prompt_token_ids=None)
    assert got == want
    assert all(row[0] != 2 for row in got)   # min_new_tokens=1 bans EOS first


def test_hfbeam_is_the_jax_engine_step_for_step():
    rng = np.random.default_rng(6)
    kw = dict(length_penalty=1.5, do_sample=True, temperature=0.9, top_p=0.8,
              min_new_tokens=2, seed=3)
    a, b = jb.HFBeam(2, 3, 16, 5, 7, **kw), tb.HFBeam(2, 3, 16, 5, 7, **kw)
    for _ in range(5):
        logits = rng.normal(size=(6, 16)).astype(np.float32) * 3
        ra, rb = a.step(logits), b.step(logits)
        np.testing.assert_array_equal(ra[0], rb[0])
        np.testing.assert_array_equal(ra[1], rb[1])
        assert ra[2] == rb[2]
        if ra[2]:
            break
    assert a.final() == b.final()
    scores = np.log(np.array([[0.5, 0.3, 0.15, 0.05]], np.float32))
    np.testing.assert_array_equal(tb._top_p_warp(scores, 0.8), jb._top_p_warp(scores, 0.8))
