"""The port's continuous-batching engine (mertools_tpu_torch/mllm/serve.py):
each request's greedy tokens equal the JAX engine's and the port's
``generate`` for that prompt alone — batched and serial admission,
staggered admission, per-request budgets, w8 weights, a shared prefix with
and without the repetition penalty, token-id and embedding submission —
and the power-of-two padding rows of an admission never touch a live slot."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.mllm import generate as jg
from mertools_tpu.mllm import llm as jl
from mertools_tpu.mllm.serve import ContinuousBatcher as JEngine
from mertools_tpu_torch.mllm import generate as tg
from mertools_tpu_torch.mllm import llm as tl
from mertools_tpu_torch.mllm.serve import ContinuousBatcher

torch.set_num_threads(1)

EOS = 88


@pytest.fixture(scope="module")
def llm():
    cfg = jl.LLMConfig(vocab_size=89, hidden_size=32, num_layers=2, num_heads=4,
                       num_kv_heads=2, intermediate_size=64)
    model = jl.LLM(cfg)

    def both(mdl, embeds, ids):
        mdl.embed(ids)
        return mdl(embeds)

    # jitted: one compile, where an eager init dispatches each primitive
    params = jax.jit(functools.partial(model.init, method=both))(
        jax.random.PRNGKey(5), np.zeros((1, 4, 32), np.float32),
        np.zeros((1, 1), np.int32))["params"]
    return cfg, params


def _port(cfg, params, w8=None):
    tcfg = tl.LLMConfig(**dataclasses.asdict(cfg))
    model = tl.LLM(tcfg)
    if w8 is None:
        model.load_state_dict(tl.state_dict_from_flax(tcfg, params))
    else:
        tg.quantize_llm_w8(model)
        model.load_state_dict(tg.w8_state_dict_from_flax(tcfg, w8))
    return model.eval()


def _solo(model, emb, max_new, eos=EOS):
    out = tg.generate(model, torch.from_numpy(emb[None]),
                      torch.ones(1, len(emb), dtype=torch.long),
                      max_new_tokens=max_new, eos_token_id=eos)[0].tolist()
    return out[: out.index(eos)] if eos in out else out


def _prompts(lens, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, 32)).astype(np.float32) * scale for n in lens]


def _drain(eng, prompts, **kw):
    rids = [eng.submit(p, **kw) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("admit_batched", [True, False])
def test_engine_equals_generate_and_the_jax_engine(llm, admit_batched):
    cfg, params = llm
    prompts = _prompts((5, 11, 3, 17, 8), 0)
    kw = dict(n_slots=4, max_len=64, eos_token_id=EOS, max_new_tokens=10,
              prefill_buckets=(8, 16, 32), admit_batched=admit_batched)
    model = _port(cfg, params)
    got = _drain(ContinuousBatcher(model, device="cpu", **kw), prompts)
    want = _drain(JEngine(cfg, params, **kw), prompts)
    assert got == want
    assert got == [_solo(model, p, 10) for p in prompts]


def test_staggered_admission_and_per_request_budgets(llm):
    cfg, params = llm
    model = _port(cfg, params)
    prompts = _prompts((5, 9, 3, 12, 7, 4), 1)
    budgets = [3, 10, 1, 7, 10, 5]

    def drive(eng):
        rids = [eng.submit(prompts[i], max_new_tokens=budgets[i]) for i in range(3)]
        nxt = 3
        while nxt < len(prompts) or eng.queue or eng.active.any():
            if nxt < len(prompts):   # admission interleaved with decoding
                rids.append(eng.submit(prompts[nxt], max_new_tokens=budgets[nxt]))
                nxt += 1
            eng.step()
        return [eng.finished[r] for r in rids]

    kw = dict(n_slots=3, max_len=64, eos_token_id=-1, max_new_tokens=10,
              prefill_buckets=(16,), chunk=4)
    got = drive(ContinuousBatcher(model, device="cpu", **kw))
    assert got == drive(JEngine(cfg, params, **kw))
    for toks, b, p in zip(got, budgets, prompts):
        assert len(toks) == b and toks == _solo(model, p, b, eos=-1)
    eng = ContinuousBatcher(model, device="cpu", **kw)
    for bad in (0, 11):
        with pytest.raises(ValueError):
            eng.submit(prompts[0], max_new_tokens=bad)


def test_w8_engine_equals_jax_packed_engine(llm):
    cfg, params = llm
    packed = jg.quantize_llm_params_w8(params)
    prompts = _prompts((5, 9), 2)
    kw = dict(n_slots=2, max_len=32, eos_token_id=EOS, max_new_tokens=8,
              prefill_buckets=(16,))
    got = _drain(ContinuousBatcher(_port(cfg, params, w8=packed), device="cpu", **kw),
                 prompts)
    assert got == _drain(JEngine(cfg, packed, **kw), prompts)


@pytest.mark.parametrize("rp", [1.0, 1.4])
def test_shared_prefix_equals_full_prompts_and_jax(llm, rp):
    cfg, params = llm
    model = _port(cfg, params)
    rng = np.random.default_rng(3)
    table = np.asarray(params["embed_tokens"]["embedding"])
    pre = rng.integers(3, 88, size=12)
    sufs = [rng.integers(3, 88, size=n) for n in (4, 7, 2, 9)]
    kw = dict(n_slots=2, max_len=64, eos_token_id=EOS, max_new_tokens=8,
              prefill_buckets=(8, 16, 32), repetition_penalty=rp)
    full = ContinuousBatcher(model, device="cpu", **kw)
    rids = [full.submit(table[np.concatenate([pre, s])],
                        prompt_ids=np.concatenate([pre, s]) if rp != 1.0 else None)
            for s in sufs]
    out = full.run()
    want = [out[r] for r in rids]

    tpre = tg.prefill_prefix(model, torch.from_numpy(table[pre]))
    eng = ContinuousBatcher(model, device="cpu", prefix=tpre,
                            prefix_token_ids=pre if rp != 1.0 else None, **kw)
    jeng = JEngine(cfg, params, prefix=jg.prefill_prefix(cfg, params,
                                                         jnp.asarray(table[pre])),
                   prefix_token_ids=pre if rp != 1.0 else None, **kw)
    for e in (eng, jeng):
        ids = [e.submit(table[s], prompt_ids=s if rp != 1.0 else None) for s in sufs]
        res = e.run()
        assert [res[r] for r in ids] == want


def test_token_id_submission_equals_embeddings_and_jax(llm):
    cfg, params = llm
    model = _port(cfg, params)
    table = np.asarray(params["embed_tokens"]["embedding"])
    rng = np.random.default_rng(4)
    ids_list = [rng.integers(1, 88, size=n) for n in (5, 11, 3, 17)]
    kw = dict(n_slots=2, max_len=64, eos_token_id=EOS, max_new_tokens=10,
              prefill_buckets=(8, 16, 32), repetition_penalty=1.3)
    by_emb = _drain(ContinuousBatcher(model, device="cpu", **kw),
                    [table[i] for i in ids_list])
    eng = ContinuousBatcher(model, device="cpu", **kw)
    rids = [eng.submit(prompt_ids=i) for i in ids_list]
    out = eng.run()
    jeng = JEngine(cfg, params, **kw)
    jrids = [jeng.submit(prompt_ids=i) for i in ids_list]
    jout = jeng.run()
    assert [out[r] for r in rids] == [jout[r] for r in jrids]
    # without prompt ids the penalty counts only generated tokens
    assert by_emb == _drain(JEngine(cfg, params, **kw), [table[i] for i in ids_list])


def test_padding_rows_never_touch_a_live_slot(llm):
    """A group of 3 pads to 4 rows; the dummy row is prefilled and dropped,
    so the live slot's cache and state stay as they were."""
    cfg, params = llm
    eng = ContinuousBatcher(_port(cfg, params), device="cpu", n_slots=4, max_len=64,
                            eos_token_id=-1, max_new_tokens=20, prefill_buckets=(16,),
                            chunk=2)
    first = _prompts((6,), 5)[0]
    rid = eng.submit(first)
    eng.step()
    live = int(np.nonzero(eng.active)[0][0])
    before = {k: v.clone() for k, v in eng._dev.items()}
    kc = eng.k_cache[:, live].clone()
    for p in _prompts((4, 9, 7), 6):
        eng.submit(p)
    with torch.inference_mode():
        eng._admit()
    assert torch.equal(eng.k_cache[:, live], kc)
    for k, v in eng._dev.items():
        assert torch.equal(v[live], before[k][live]), k
    assert sorted(np.nonzero(eng.active)[0].tolist()) == [0, 1, 2, 3]
    out = eng.run()
    assert out[rid] == _solo(eng.model, first, 20, eos=-1)


def test_bf16_engine_is_deterministic_and_in_range(llm):
    cfg, params = llm
    prompts = _prompts((5, 11, 3), 7)

    def run():
        eng = ContinuousBatcher(_port(cfg, params), device="cpu", n_slots=2, max_len=64,
                                eos_token_id=EOS, max_new_tokens=8,
                                prefill_buckets=(8, 16, 32), compute_dtype="bf16")
        assert eng.k_cache.dtype == torch.bfloat16
        return _drain(eng, prompts)

    a = run()
    assert a == run()
    assert all(0 < len(t) <= 8 and all(0 <= x < cfg.vocab_size for x in t) for t in a)


def test_sampling_engine_reproduces_per_seed(llm):
    cfg, params = llm
    prompts = _prompts((5, 9, 12), 8)

    def run(seed):
        eng = ContinuousBatcher(_port(cfg, params), device="cpu", n_slots=2, max_len=64,
                                eos_token_id=EOS, max_new_tokens=8,
                                prefill_buckets=(8, 16, 32), temperature=0.8,
                                top_p=0.9, repetition_penalty=1.05, seed=seed)
        return _drain(eng, prompts)

    a = run(0)
    assert a == run(0) and a != run(123)


def test_engine_needs_a_card_unless_asked_for_the_cpu(llm, monkeypatch):
    cfg, params = llm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(_port(cfg, params))
