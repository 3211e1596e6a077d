"""The port's KV-cached generation (mertools_tpu_torch/mllm/generate.py)
against the JAX module on the same weights (``llm.state_dict_from_flax``),
fp32 at Precision.HIGHEST: prefill logits and caches, the shared-prefix
prefill, greedy tokens (LoRA, ragged batches, prefix, kv_int8, w8,
repetition penalty, M-RoPE), ``_quant_kv`` codes, the w8 codes and scales,
the nucleus support of the sampler, ``batch_generate_texts`` and the bf16
serving math. The port's cache layout is (layers, B, kv_heads, L, hd); the
JAX caches are transposed to it for comparison."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.mllm import generate as jg
from mertools_tpu.mllm import llm as jl
from mertools_tpu_torch.mllm import generate as tg
from mertools_tpu_torch.mllm import llm as tl

torch.set_num_threads(1)

TOL = 1e-4   # fp32 logits: max |port - jax| / max |jax|
EOS = 88


def _jax_params(cfg, seed=7):
    model = jl.LLM(cfg)

    def both(mdl, embeds, ids):
        mdl.embed(ids)
        return mdl(embeds)

    params = model.init(jax.random.PRNGKey(seed),
                        np.zeros((1, 4, cfg.hidden_size), np.float32),
                        np.zeros((1, 1), np.int32), method=both)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):   # non-zero LoRA B, so the deltas take part
        if getattr(path[-1], "key", None) == "lora_b":
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.1, jnp.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, params)


def _port(cfg, params):
    tcfg = tl.LLMConfig(**dataclasses.asdict(cfg))
    model = tl.LLM(tcfg)
    model.load_state_dict(tl.state_dict_from_flax(tcfg, params), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.LLMConfig(vocab_size=89, hidden_size=32, num_layers=2, num_heads=4,
                       num_kv_heads=2, intermediate_size=64, lora_r=2)
    params = _jax_params(cfg)
    return cfg, params, _port(cfg, params)


def _ragged(cfg, lens, S, seed=3, scale=0.5):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(len(lens), S, cfg.hidden_size)).astype(np.float32) * scale
    mask = (np.arange(S)[None] < np.asarray(lens)[:, None]).astype(np.int32)
    emb *= mask[..., None]
    return emb, mask


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _jcache(c):   # JAX (layers, B, L, nkv, hd) -> the port's layout
    return np.swapaxes(np.asarray(c), 2, 3)


def test_prefill_logits_and_caches_match_jax(tiny):
    cfg, params, model = tiny
    emb, mask = _ragged(cfg, (9, 4, 1), 12)
    jl_, jk, jv, jn = jg.prefill(cfg, params, jnp.asarray(emb), jnp.asarray(mask), 20)
    tl_, tk, tv, tn = tg.prefill(model, torch.from_numpy(emb), torch.from_numpy(mask), 20)
    assert _rel(tl_, jl_) <= TOL
    assert _rel(tk, _jcache(jk)) <= TOL and _rel(tv, _jcache(jv)) <= TOL
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_prefix_prefill_matches_jax(tiny):
    cfg, params, model = tiny
    rng = np.random.default_rng(5)
    pre = rng.normal(size=(10, cfg.hidden_size)).astype(np.float32) * 0.5
    emb, mask = _ragged(cfg, (5, 2), 8)
    jpre = jg.prefill_prefix(cfg, params, jnp.asarray(pre))
    tpre = tg.prefill_prefix(model, torch.from_numpy(pre))
    assert _rel(tpre[0], np.swapaxes(np.asarray(jpre[0]), 1, 2)) <= TOL
    jl_, jk, _, jn = jg.prefill(cfg, params, jnp.asarray(emb), jnp.asarray(mask), 24,
                                prefix=jpre)
    tl_, tk, _, tn = tg.prefill(model, torch.from_numpy(emb), torch.from_numpy(mask), 24,
                                prefix=tpre)
    assert _rel(tl_, jl_) <= TOL and _rel(tk, _jcache(jk)) <= TOL
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("kv_int8", [False, True])
def test_greedy_tokens_equal_jax_on_a_ragged_batch(tiny, kv_int8):
    cfg, params, model = tiny
    emb, mask = _ragged(cfg, (7, 3, 11), 11)
    want = np.asarray(jg.generate(cfg, params, jnp.asarray(emb), jnp.asarray(mask),
                                  max_new_tokens=10, eos_token_id=EOS, kv_int8=kv_int8))
    got = tg.generate(model, torch.from_numpy(emb), torch.from_numpy(mask),
                      max_new_tokens=10, eos_token_id=EOS, kv_int8=kv_int8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefix_generate_equals_full_prompt_and_jax(tiny):
    cfg, params, model = tiny
    rng = np.random.default_rng(8)
    table = np.asarray(params["embed_tokens"]["embedding"])
    pre = rng.integers(3, 88, size=12)
    sufs = [rng.integers(3, 88, size=n) for n in (4, 7, 1)]
    semb = np.zeros((3, 7, cfg.hidden_size), np.float32)
    smask = np.zeros((3, 7), np.int32)
    femb = np.zeros((3, 19, cfg.hidden_size), np.float32)
    fmask = np.zeros((3, 19), np.int32)
    for b, suf in enumerate(sufs):
        semb[b, : len(suf)], smask[b, : len(suf)] = table[suf], 1
        ids = np.concatenate([pre, suf])
        femb[b, : len(ids)], fmask[b, : len(ids)] = table[ids], 1
    jpre = jg.prefill_prefix(cfg, params, jnp.asarray(table[pre]))
    want = np.asarray(jg.generate(cfg, params, jnp.asarray(semb), jnp.asarray(smask),
                                  max_new_tokens=8, eos_token_id=EOS, prefix=jpre))
    tpre = tg.prefill_prefix(model, torch.from_numpy(table[pre]))
    got = tg.generate(model, torch.from_numpy(semb), torch.from_numpy(smask),
                      max_new_tokens=8, eos_token_id=EOS, prefix=tpre).numpy()
    full = tg.generate(model, torch.from_numpy(femb), torch.from_numpy(fmask),
                       max_new_tokens=8, eos_token_id=EOS).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full)


def test_quant_kv_codes_bit_equal():
    x = np.random.default_rng(1).normal(size=(2, 3, 5, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0   # an all-zero head takes the 1e-8 floor
    jq, js = jg._quant_kv(jnp.asarray(x))
    tq, ts = tg._quant_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_w8_codes_scales_and_tokens_match_jax(tiny):
    """The port's quantize_llm_w8 gives JAX's codes and scales bit for bit;
    JAX's packed tree loaded into W8Linears decodes JAX's greedy tokens."""
    cfg, params, _ = tiny
    jp8 = jg.quantize_llm_params_w8(params)
    model = tg.quantize_llm_w8(_port(cfg, params))
    for i in range(cfg.num_layers):
        for n in tg._W8_KERNELS:
            lin = getattr(model.layers[i].self_attn if n in tg._ATTN else model.layers[i].mlp, n)
            pk = jp8[f"layer_{i}"][n]["kernel"]
            np.testing.assert_array_equal(lin.q.numpy(), np.asarray(pk["q"]).T)
            np.testing.assert_array_equal(lin.scale.numpy(), np.asarray(pk["scale"]))
    np.testing.assert_array_equal(model.lm_head.q.numpy(),
                                  np.asarray(jp8["lm_head"]["kernel"]["q"]).T)

    loaded = tg.quantize_llm_w8(_port(cfg, params))
    loaded.load_state_dict(tg.w8_state_dict_from_flax(cfg, jp8), strict=True)
    emb, mask = _ragged(cfg, (6, 9), 9, seed=4)
    jl_, *_ = jg.prefill(cfg, jp8, jnp.asarray(emb), jnp.asarray(mask), 12)
    tl_, *_ = tg.prefill(loaded, torch.from_numpy(emb), torch.from_numpy(mask), 12)
    assert _rel(tl_, jl_) <= TOL
    want = np.asarray(jg.generate(cfg, jp8, jnp.asarray(emb), jnp.asarray(mask),
                                  max_new_tokens=8, eos_token_id=EOS))
    got = tg.generate(loaded, torch.from_numpy(emb), torch.from_numpy(mask),
                      max_new_tokens=8, eos_token_id=EOS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_w8_linear_equals_its_dequantized_weights(tiny):
    cfg, params, _ = tiny
    model = _port(cfg, params)
    lin = model.layers[0].self_attn.q_proj
    w8 = tg.W8Linear.from_linear(lin)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 5, 32)).astype(np.float32))
    ref = torch.nn.functional.linear(x, w8.dequantized()) + lin.scale * (
        x @ lin.lora_A.T @ lin.lora_B.T)
    assert _rel(w8(x).detach(), ref.detach()) <= 1e-6


def test_repetition_penalty_tokens_equal_jax(tiny):
    cfg, params, model = tiny
    emb, mask = _ragged(cfg, (5, 8), 8, seed=6)
    ids = np.random.default_rng(6).integers(3, 88, size=(2, 8)) * mask
    want = np.asarray(jg.generate(cfg, params, jnp.asarray(emb), jnp.asarray(mask),
                                  max_new_tokens=10, eos_token_id=EOS,
                                  repetition_penalty=1.5,
                                  prompt_token_ids=jnp.asarray(ids)))
    got = tg.generate(model, torch.from_numpy(emb), torch.from_numpy(mask),
                      max_new_tokens=10, eos_token_id=EOS, repetition_penalty=1.5,
                      prompt_token_ids=torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)


def _np_support(logits, temperature, top_p, top_k):
    """The JAX ``_sample`` filter in numpy: the tokens it can draw."""
    z = logits / temperature
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    if top_k:
        kth = np.sort(p, -1)[:, -top_k][:, None]
        p = np.where(p >= kth, p, 0.0)
    srt = -np.sort(-p, -1)
    cut = np.argmax(np.cumsum(srt, -1) >= top_p, -1)
    cutoff = np.take_along_axis(srt, cut[:, None], -1)
    return [set(np.nonzero(row >= c)[0].tolist()) for row, c in zip(p, cutoff)]


@pytest.mark.parametrize("top_k,rp", [(0, 1.0), (3, 1.0), (0, 1.3)])
def test_sampler_draws_the_jax_nucleus(top_k, rp):
    """200 draws of the port and of JAX from the same logits cover the same
    support, which is the numpy filter's; the filtered probabilities equal
    it to fp32 rounding."""
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(2, 40)).astype(np.float32)
    logits[:, :4] += np.array([6.0, 5.8, 5.5, 5.2], np.float32)
    seen = np.zeros((2, 40), np.int32)
    seen[:, 1] = 1
    pen = logits
    if rp != 1.0:
        pen = np.where(seen > 0, np.where(logits > 0, logits / rp, logits * rp), logits)
    support = _np_support(pen.astype(np.float64), 0.8, 0.9, top_k)
    jsamp = jax.jit(lambda k: jg._sample(jnp.asarray(logits), k, 0.8, 0.9,
                                         jnp.asarray(seen), rp, top_k))
    jdraws = np.stack([np.asarray(jsamp(k))
                       for k in jax.random.split(jax.random.PRNGKey(0), 200)])
    gen = torch.Generator().manual_seed(0)
    tdraws = np.stack([tg._sample(torch.from_numpy(logits), gen, 0.8, 0.9,
                                  torch.from_numpy(seen), rp, top_k).numpy()
                       for _ in range(200)])
    for b in range(2):
        assert set(jdraws[:, b].tolist()) == support[b]
        assert set(tdraws[:, b].tolist()) == support[b]
    probs = tg.filtered_probs(tg._penalize(torch.from_numpy(logits),
                                           torch.from_numpy(seen), rp), 0.8, 0.9, top_k)
    for b in range(2):
        assert set(np.nonzero(probs[b].numpy())[0].tolist()) == support[b]


def test_batch_generate_texts_equals_jax(tiny):
    """Length-sorted batches with a short last batch (dummy rows dropped),
    the shared prefix and the penalty's prompt seeding: the JAX texts."""
    cfg, params, model = tiny

    class Tok:
        eos_token_id = EOS

        def decode(self, ids, skip_special_tokens=True):
            return " ".join(str(int(i)) for i in ids)

    rng = np.random.default_rng(10)
    pre = rng.integers(3, 88, size=20).tolist()
    ids_by_key = {f"k{i}": pre + rng.integers(3, 88, size=n).tolist()
                  for i, n in enumerate((3, 7, 5, 2, 9))}
    table = np.asarray(params["embed_tokens"]["embedding"])
    for rp in (1.0, 1.3):
        want = jg.batch_generate_texts(cfg, params, table, ids_by_key, Tok(), batch=2,
                                       max_new_tokens=6, repetition_penalty=rp,
                                       min_prefix=8)
        got = tg.batch_generate_texts(model, ids_by_key, Tok(), batch=2,
                                      max_new_tokens=6, repetition_penalty=rp,
                                      min_prefix=8, device="cpu")
        assert got == want


def test_cached_decode_matches_the_full_forward(tiny):
    """Teacher-forced: each decode step's logits equal LLM.forward's at that
    position on the same tokens (the chip phase's cached-vs-full check)."""
    cfg, params, model = tiny
    emb, mask = _ragged(cfg, (6, 3), 6, seed=11)
    toks = tg.generate(model, torch.from_numpy(emb), torch.from_numpy(mask),
                       max_new_tokens=5, eos_token_id=-1)
    steps = tg.decode_logits(model, torch.from_numpy(emb), torch.from_numpy(mask), toks)
    full = tg.teacher_forced_logits(model, torch.from_numpy(emb), torch.from_numpy(mask),
                                    toks)
    assert _rel(steps, full) <= TOL


def test_mrope_greedy_tokens_equal_jax():
    cfg = jl.LLMConfig(vocab_size=89, hidden_size=32, num_layers=2, num_heads=4,
                       num_kv_heads=2, intermediate_size=64, mrope_section=(2, 1, 1))
    params = _jax_params(cfg, seed=3)
    model = _port(cfg, params)
    emb, mask = _ragged(cfg, (6, 4), 6, seed=12)
    pos = np.random.default_rng(12).integers(0, 5, size=(2, 6, 3))
    want = np.asarray(jg.generate(cfg, params, jnp.asarray(emb), jnp.asarray(mask),
                                  max_new_tokens=6, eos_token_id=EOS,
                                  positions=jnp.asarray(pos)))
    got = tg.generate(model, torch.from_numpy(emb), torch.from_numpy(mask),
                      max_new_tokens=6, eos_token_id=EOS, positions=torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_prefill_follows_the_jax_serving_math(tiny):
    """bf16 weights and activations: the port's prefill logits lie as close
    to JAX's bf16 as bf16 rounding allows, and much closer than to fp32."""
    cfg, params, _ = tiny
    emb, mask = _ragged(cfg, (9, 5), 9, seed=13)
    jb = jg.cast_llm_params_bf16(params)
    jl_, *_ = jg.prefill(cfg, jb, jnp.asarray(emb), jnp.asarray(mask), 12)
    model = tg.cast_llm_bf16(_port(cfg, params))
    tl_, tk, _, _ = tg.prefill(model, torch.from_numpy(emb), torch.from_numpy(mask), 12)
    assert tk.dtype == torch.bfloat16
    assert _rel(tl_, np.asarray(jl_)) <= 2e-2


def test_helpers_equal_jax():
    lists = [[1, 2, 3, 4, 5], [1, 2, 3, 9], [1, 2, 3, 4]]
    for mp in (1, 2, 3, 4):
        assert tg.common_token_prefix(lists, mp) == jg.common_token_prefix(lists, mp)
    assert tg.common_token_prefix(lists[:1]) == 0
    for n, kw in ((1, {}), (64, {}), (65, {}), (100, {"mult": 8}),
                  (300, {"cap": 256}), (3, {"cap": 10})):
        assert tg.bucket_len(n, **kw) == jg.bucket_len(n, **kw)


def test_serving_entry_points_need_a_card_unless_asked_for_the_cpu(tiny, monkeypatch):
    cfg, params, model = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.batch_generate_texts(model, {"a": [3, 4]}, None)
