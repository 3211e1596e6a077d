"""The port's emotion2vec (``mertools_tpu_torch/encoders/emotion2vec.py``,
``Emotion2VecExtractor``) against the JAX package's: the encoder from
``state_dict_from_flax`` weights with funasr's nested ``project_features``
layout and an even positional kernel (SamePad's trim), the converter's
round trip with ``_ema`` and decoder keys left out, pad invariance, and the
extractor's trimming and truncation at the CLI's tiny config, on seeded
inputs. One jitted JAX forward a config, built once a module."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mertools_tpu.encoders import emotion2vec as je
from mertools_tpu.features import audio as jfa
from mertools_tpu_torch.encoders import emotion2vec as te
from mertools_tpu_torch.features import audio as tfa
from test_torch_audio_zoo import assert_feats_close, assert_trees_equal, close, fill_flax

torch.set_num_threads(1)

# funasr's nested project_features (LayerNorm + Linear), 4-wide positional
# kernels (trimmed by SamePad), biased local convs
NESTED = dict(conv_layers=((24, 10, 5), (24, 3, 2), (24, 2, 2)), hidden_size=32,
              prenet_depth=2, depth=2, num_heads=4, mlp_ratio=2, conv_pos_depth=2,
              conv_pos_width=8, conv_pos_groups=4, conv_bias=True, project_ln=True)
# the JAX CLI's --random_init config
CLI_TINY = dict(conv_layers=((32, 10, 5), (32, 8, 4)), hidden_size=32, prenet_depth=1,
                depth=1, num_heads=4, conv_pos_depth=2, conv_pos_width=10,
                conv_pos_groups=4)


def _jax_model(kw: dict, seed: int):
    cfg = je.Emotion2VecConfig(**kw)
    model = je.Emotion2Vec(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 4000)),
                            jnp.full((1,), 4000, jnp.int32))["params"]
    params = fill_flax(shapes, seed)
    return cfg, params, jax.jit(lambda p, w, n: model.apply({"params": p}, w, n))


@pytest.fixture(scope="module")
def nested():
    jcfg, params, fwd = _jax_model(NESTED, 10)
    cfg = te.Emotion2VecConfig(**NESTED)
    return jcfg, params, fwd, cfg, te.state_dict_from_flax(cfg, params)


def _batch(lens, seed):
    rng = np.random.default_rng(seed)
    wavs = [(0.2 * rng.normal(size=L)).astype(np.float32) for L in lens]
    batch = np.zeros((len(lens), max(lens)), np.float32)
    for r, w in enumerate(wavs):
        batch[r, : len(w)] = w
    return wavs, batch, np.array(lens, np.int32)


def test_encoder_from_flax_weights_matches_jax_and_is_pad_invariant(nested):
    """A right-padded batch equals JAX's (frames and mask); the shorter
    clip's valid frames equal it run alone."""
    _, params, fwd, cfg, sd = nested
    model = te.Emotion2Vec(cfg)
    model.load_state_dict(sd, strict=True)
    wavs, batch, lens = _batch((2400, 3200), 11)
    with torch.no_grad():
        h, mask = model(torch.from_numpy(batch), torch.from_numpy(lens))
        solo, smask = model(torch.from_numpy(wavs[0][None]), torch.tensor([2400]))
    jh, jmask = fwd(params, jnp.asarray(batch), jnp.asarray(lens))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    close(h.numpy(), jh)
    n0 = int(te.out_lengths(2400, cfg))
    assert int(smask.sum()) == int(mask[0].sum()) == n0
    close(h[0, :n0].numpy(), solo[0].numpy(), 1e-5)


def test_converter_round_trip_leaves_out_ema_and_decoder_keys(nested):
    """The port's state dict, with a teacher copy and decoders added,
    converts back to the JAX tree (and the config the weights imply) through
    JAX's ``convert_funasr_state``; the port's own converter keeps exactly
    the module's keys and infers the same config."""
    jcfg, params, _, cfg, sd = nested
    full = dict(sd)
    full["_ema.blocks.0.attn.qkv.weight"] = torch.zeros(1)
    full["modality_encoders.AUDIO.decoder.proj.weight"] = torch.zeros(1)
    full["decoder.blocks.0.weight"] = torch.zeros(1)
    got_cfg, got = je.convert_funasr_state(full, conv_strides=(5, 2, 2), num_heads=4)
    assert got_cfg == jcfg
    assert_trees_equal(got, params)
    tcfg, tsd = te.convert_funasr_state(full, conv_strides=(5, 2, 2), num_heads=4)
    assert tcfg == cfg and tcfg.project_ln and sorted(tsd) == sorted(sd)
    assert "modality_encoders.AUDIO.project_features.2.weight" in tsd
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(got_cfg)


def test_extractor_matches_jax_trimming_and_truncation(capsys):
    """The CLI's tiny config, buckets (4000, 8000): frames trimmed to
    ``max(out_lengths, 1)``, FRA and UTT, a 9500-sample clip truncated."""
    jcfg, params, _ = _jax_model(CLI_TINY, 12)
    cfg = te.Emotion2VecConfig(**CLI_TINY)
    sd = te.state_dict_from_flax(cfg, params)
    rng = np.random.default_rng(13)
    wavs = {f"w{L}": (0.1 * rng.normal(size=L)).astype(np.float32)
            for L in (2500, 4000, 7000, 9500)}
    want = jfa.Emotion2VecExtractor(params, jcfg, buckets=(4000, 8000))
    got = tfa.Emotion2VecExtractor(sd, cfg, buckets=(4000, 8000), device="cpu")
    for level in ("FRA", "UTT"):
        assert_feats_close(got.extract(wavs, level), want.extract(wavs, level))
    fra = got.extract(wavs, "FRA")
    assert {n: f.shape for n, f in fra.items()} == {
        f"w{L}": (int(te.out_lengths(min(L, 8000), cfg)), 32) for L in (2500, 4000, 7000, 9500)}
    assert "truncating to 8000" in capsys.readouterr().out
