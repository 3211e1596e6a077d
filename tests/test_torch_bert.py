"""The port's BERT-family encoder against the JAX package's ``BertEncoder``
on tiny configs (4 layers): the same Flax params carried across by
``state_dict_from_flax``, the same numpy inputs, every hidden state within
1e-4 in fp32 on the CPU, for BERT, RoBERTa (pad-offset position ids) and
ELECTRA (factorised embeddings), on the inline and the flash route; and the
raw-checkpoint loader against the converter."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.encoders import bert as jb
from mertools_tpu_torch.encoders import bert as tb

torch.set_num_threads(1)

TOL = 1e-4  # fp32 on both sides; differences are summation order only
SMALL = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
             intermediate_size=48, vocab_size=60, max_position_embeddings=64)


def _hf(kind, head=False):
    import transformers as tr

    torch.manual_seed(0)
    if kind == "bert":
        cfg = tr.BertConfig(**SMALL)
        return cfg, (tr.BertForMaskedLM if head else tr.BertModel)(cfg).eval()
    if kind == "roberta":
        cfg = tr.RobertaConfig(**{**SMALL, "max_position_embeddings": 70},
                               pad_token_id=1)
        return cfg, tr.RobertaModel(cfg).eval()
    cfg = tr.ElectraConfig(**SMALL, embedding_size=16)
    return cfg, tr.ElectraModel(cfg).eval()


_MODELS = {}


def _models(kind):
    """(HF config, JAX config, Flax params, jitted JAX forward), built once
    per kind and module."""
    if kind not in _MODELS:
        hf_cfg, hf = _hf(kind)
        jcfg, params = jb.from_hf_torch(hf)
        fwd = jax.jit(lambda p, ids, m: jb.BertEncoder(jcfg).apply(
            {"params": p}, ids, m))
        _MODELS[kind] = (hf_cfg, jcfg, params, fwd)
    return _MODELS[kind]


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 60, size=(3, 13)).astype(np.int32)
    mask = np.ones_like(ids)
    for r, n in enumerate((13, 9, 2)):      # right padding, as the extractor
        mask[r, n:] = 0
        ids[r, n:] = 1                      # RoBERTa's pad id
    return ids, mask


@pytest.mark.parametrize("flash", [False, True], ids=["inline", "flash"])
@pytest.mark.parametrize("kind", ["bert", "roberta", "electra"])
def test_hidden_states_match_jax(kind, flash):
    hf_cfg, jcfg, params, fwd = _models(kind)
    tcfg = tb.BertConfig.from_hf(hf_cfg.to_dict())
    assert dataclasses.asdict(tcfg) == {**dataclasses.asdict(jcfg),
                                        "use_flash_attention": False}
    enc = tb.BertEncoder(dataclasses.replace(tcfg, use_flash_attention=flash))
    enc.load_state_dict(tb.state_dict_from_flax(tcfg, params), strict=True)
    ids, mask = _inputs()
    ref = fwd(params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        out = enc.eval()(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert len(out) == len(ref) == 5
    valid = mask.astype(bool)   # pad query rows are thrown away by callers
    for r, o in zip(ref, out):
        assert o.shape == r.shape
        assert np.abs(o.numpy()[valid] - np.asarray(r)[valid]).max() < TOL


def test_load_hf_state_dict_of_a_masked_lm_checkpoint():
    """A BertForMaskedLM save: ``bert.`` prefix, the MLM head and the
    pooler-less body; old ``LayerNorm.gamma``/``beta`` names. The loader
    gives the converter's state dict, which loads strictly."""
    _, hf = _hf("bert", head=True)
    sd = hf.state_dict()
    assert any(k.startswith("cls.") for k in sd)
    sd = {(k.replace("LayerNorm.weight", "LayerNorm.gamma")
           .replace("LayerNorm.bias", "LayerNorm.beta")
           if k.startswith("bert.encoder.layer.1.") else k): v
          for k, v in sd.items()}
    assert "bert.encoder.layer.1.output.LayerNorm.gamma" in sd
    got = tb.load_hf_state_dict(sd)
    jcfg, params = jb.from_hf_torch(hf.bert)
    want = tb.state_dict_from_flax(tb.BertConfig(**dataclasses.asdict(jcfg)),
                                   params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    tb.BertEncoder(tb.BertConfig(**dataclasses.asdict(jcfg))).load_state_dict(
        got, strict=True)


def test_init_params_load_strictly_with_bert_scales():
    """HF's BERT initialisation: weights and tables normal(0, 0.02)."""
    cfg = tb.BertConfig(**SMALL, embedding_size=16)
    sd = tb.init_params(cfg, torch.Generator().manual_seed(0))
    enc = tb.BertEncoder(cfg)
    enc.load_state_dict(sd, strict=True)
    for key in ("encoder.layer.0.intermediate.dense.weight",
                "embeddings.word_embeddings.weight", "embeddings_project.weight"):
        assert float(sd[key].std()) == pytest.approx(0.02, rel=0.2), key
    assert (sd["encoder.layer.0.output.LayerNorm.weight"] == 1).all()
    assert not sd["encoder.layer.0.output.dense.bias"].any()
    again = tb.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)
