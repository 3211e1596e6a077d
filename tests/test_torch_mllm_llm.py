"""The port's ``LLM`` (mertools_tpu_torch/mllm/llm.py) against the JAX ``LLM``
at Precision.HIGHEST on the same weights (``state_dict_from_flax``): logits,
hidden states, the chunked loss against the dense one, ``lm_loss``, M-RoPE,
q/k/v biases and LoRA, on both attention paths; and both packages against an
HF tiny ``LlamaForCausalLM``. The flash path (kernel B3's plain version on
the CPU) is compared on valid rows: the JAX XLA path masks keys only, so pad
query rows differ by design."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.mllm import llm as jl
from mertools_tpu_torch.mllm import llm as tl

torch.set_num_threads(1)

TOL = 3e-4   # max |port - jax| / max |jax|, fp32 on both sides
LENS = np.array([20, 13, 5])


def _cfg(**kw):
    base = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, intermediate_size=96, lora_r=4)
    base.update(kw)
    return jl.LLMConfig(**base)


def _jax_params(cfg, seed=0):
    """Initialised JAX params with every LoRA B drawn non-zero, so the LoRA
    deltas take part, and the embedding table (``init`` on embeddings never
    creates it)."""
    x = jnp.zeros((1, 4, cfg.hidden_size))
    params = dict(jl.LLM(cfg).init(jax.random.PRNGKey(seed), x)["params"])
    rng = np.random.default_rng(seed)
    params["embed_tokens"] = {"embedding": jnp.asarray(
        rng.normal(size=(cfg.vocab_size, cfg.hidden_size)), jnp.float32)}

    def fill(path, leaf):
        if getattr(path[-1], "key", None) == "lora_b":
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.05, jnp.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, params)


def _port(cfg, params, **kw):
    tcfg = tl.LLMConfig(**{**dataclasses.asdict(cfg), **kw})
    model = tl.LLM(tcfg)
    model.load_state_dict(tl.state_dict_from_flax(tcfg, params), strict=True)
    return model.eval()


def _inputs(cfg, S=20, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(len(LENS), S, cfg.hidden_size)).astype(np.float32)
    mask = (np.arange(S)[None] < LENS[:, None]).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(len(LENS), S))
    labels[mask == 0] = -100
    labels[:, :3] = -100
    return x, mask, labels


def _rel(a, b, rows=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if rows is not None:   # valid rows only
        a, b = a[rows], b[rows]
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def base():
    cfg = _cfg()
    params = _jax_params(cfg)
    x, mask, labels = _inputs(cfg)
    model = jl.LLM(cfg)
    fwd = jax.jit(lambda p, x, m: model.apply({"params": p}, x, m,
                                              output_hidden_states=True))
    logits, hs = fwd(params, x, mask)
    loss = jax.jit(lambda p, x, m, lab: jl.lm_loss(
        model.apply({"params": p}, x, m), lab))(params, x, mask, labels)
    return cfg, params, (x, mask, labels), np.asarray(logits), \
        [np.asarray(h) for h in hs], float(loss)


@pytest.mark.parametrize("flash", [False, True])
def test_logits_and_hidden_states_match_jax(base, flash):
    cfg, params, (x, mask, _), logits, hs, _ = base
    port = _port(cfg, params, use_flash_attention=flash)
    with torch.no_grad():
        got, got_hs = port(torch.from_numpy(x), torch.from_numpy(mask),
                           output_hidden_states=True)
        hidden = port.hidden(torch.from_numpy(x), torch.from_numpy(mask))
    valid = mask.astype(bool)
    assert _rel(got.numpy(), logits, valid) <= TOL
    assert len(got_hs) == len(hs) == cfg.num_layers + 1
    for a, b in zip(got_hs, hs):
        assert _rel(a.numpy(), b, valid) <= TOL
    assert torch.equal(hidden, got_hs[-1])
    if not flash:   # the eager path is the JAX path on every row
        assert _rel(got.numpy(), logits) <= TOL


@pytest.mark.parametrize("flash", [False, True])
def test_chunked_and_dense_losses_match_jax(base, flash):
    cfg, params, (x, mask, labels), _, _, loss = base
    port = _port(cfg, params, use_flash_attention=flash)
    args = (torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(mask))
    with torch.no_grad():
        dense = port.loss(*args).item()
        chunked = [port.loss(*args, chunk=c).item() for c in (1, 7, 64)]
    assert abs(dense - loss) <= TOL * abs(loss)
    for c in chunked:
        assert abs(c - dense) <= 1e-5 * abs(dense)


def test_lm_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 7))
    labels[:, :3] = -100
    want = float(jl.lm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = tl.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("kw", [dict(mrope_section=(2, 3, 3)),
                                dict(attention_bias=True, num_kv_heads=4)])
def test_mrope_and_attention_bias_match_jax(kw):
    cfg = _cfg(**kw)
    params = _jax_params(cfg, seed=2)
    if cfg.attention_bias:   # zero-initialised: draw them so they count
        rng = np.random.default_rng(3)
        params = jax.tree_util.tree_map_with_path(
            lambda p, leaf: (jnp.asarray(rng.normal(size=leaf.shape) * 0.1,
                                         jnp.float32)
                             if getattr(p[-1], "key", None) == "bias" else leaf),
            params)
    x, mask, _ = _inputs(cfg, S=12)
    pos = None
    if cfg.mrope_section:
        rng = np.random.default_rng(4)
        pos = rng.integers(0, 9, size=(len(LENS), 12, 3)).astype(np.int32)
    want = np.asarray(jl.LLM(cfg).apply({"params": params}, x, mask, pos))
    port = _port(cfg, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask),
                   None if pos is None else torch.from_numpy(pos)).numpy()
    assert _rel(got, want) <= TOL


def test_hf_llama_loads_into_both():
    from transformers import LlamaConfig, LlamaForCausalLM

    hf_cfg = LlamaConfig(vocab_size=200, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=128,
                         rms_norm_eps=1e-6, attention_dropout=0.0,
                         initializer_range=0.1)
    torch.manual_seed(0)
    hf = LlamaForCausalLM(hf_cfg).eval()
    ids = np.random.default_rng(0).integers(0, 200, size=(2, 9))
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).logits.numpy()

    jcfg = jl.LLMConfig.from_hf(hf_cfg)
    jparams = jl.convert_torch_state(jcfg, hf.state_dict())
    jm = jl.LLM(jcfg)
    emb = jm.apply({"params": jparams}, jnp.asarray(ids, jnp.int32),
                   method=jl.LLM.embed)
    jax_logits = np.asarray(jm.apply({"params": jparams}, emb))

    tcfg = tl.LLMConfig.from_hf(hf_cfg.to_dict())   # the config.json dict
    assert dataclasses.asdict(tcfg) == {**dataclasses.asdict(jcfg),
                                        "use_flash_attention": False}
    port = tl.LLM(tcfg)
    port.load_state_dict(tl.load_hf_state_dict(hf.state_dict()), strict=True)
    with torch.no_grad():
        got = port(port.embed(torch.from_numpy(ids))).numpy()
    assert _rel(got, jax_logits) <= TOL
    assert _rel(got, ref) <= TOL


def test_lm_head_ties_to_the_embeddings_without_a_head():
    sd = {"model.embed_tokens.weight": torch.ones(5, 4),
          "model.norm.weight": torch.ones(4)}
    out = tl.load_hf_state_dict(sd)
    assert set(out) == {"embed_tokens.weight", "norm.weight", "lm_head.weight"}
    assert torch.equal(out["lm_head.weight"], out["embed_tokens.weight"])


def test_lora_trainable_and_remat_gradients():
    """set_lora_trainable leaves gradients on the LoRA deltas only; full and
    dots remat give the gradients of the plain backward."""
    cfg = _cfg()
    params = _jax_params(cfg)
    x, mask, labels = _inputs(cfg)
    grads = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        port = _port(cfg, params, remat=remat, remat_policy=policy).train()
        tl.set_lora_trainable(port)
        port.loss(torch.from_numpy(x), torch.from_numpy(labels),
                  torch.from_numpy(mask), chunk=8).backward()
        grads[(remat, policy)] = {n: p.grad for n, p in port.named_parameters()}
    plain = grads[(False, "full")]
    assert all((g is None) == (n.rsplit(".", 1)[-1] not in ("lora_A", "lora_B"))
               for n, g in plain.items())
    for key in ((True, "full"), (True, "dots")):
        for n, g in plain.items():
            if g is not None:
                assert torch.allclose(grads[key][n], g, rtol=1e-5, atol=1e-7), (key, n)


def test_config_guards():
    with pytest.raises(ValueError, match="remat_policy"):
        tl.LLMConfig.tiny().__class__(remat_policy="dot")
    with pytest.raises(NotImplementedError, match="A14"):
        tl.LLM(dataclasses.replace(tl.LLMConfig.tiny(), seq_axis="seq"))
    # a flash config whose head dim kernel B3 does not take cannot be built
    # on a CUDA device (checked before anything is allocated there)
    with pytest.raises(ValueError, match="head dim 8"):
        tl.LLM(dataclasses.replace(tl.LLMConfig.tiny(), use_flash_attention=True),
               device="cuda")
    assert tl.LLMConfig.from_hf({**dataclasses.asdict(tl.LLMConfig.tiny()),
                                 "num_hidden_layers": 2, "num_attention_heads": 4,
                                 "num_key_value_heads": 2,
                                 "model_type": "qwen2"}).attention_bias
