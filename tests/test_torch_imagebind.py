"""The port's ImageBind audio encoder (``mertools_tpu_torch/encoders/
imagebind.py``, ``ImageBindAudioExtractor``) against the JAX package's: the
bias-kv attention against ``torch.nn.MultiheadAttention(add_bias_kv=True)``
itself, the encoder from ``state_dict_from_flax`` weights on a non-square
patch grid, the converter's round trip, the checkpoint's audio subtree, and
the extractor (clip sampler, fbank, trunk) FRA and UTT, on seeded inputs.
One jitted JAX forward, built once a module."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mertools_tpu.encoders import imagebind as ji
from mertools_tpu.features import audio as jfa
from mertools_tpu_torch.encoders import imagebind as ti
from mertools_tpu_torch.features import audio as tfa
from test_torch_audio_zoo import assert_feats_close, assert_trees_equal, close, fill_flax

torch.set_num_threads(1)

# 36 x 46 mels: a (3, 4) patch grid, so a transposed flatten cannot pass
TINY = dict(embed_dim=16, num_blocks=2, num_heads=4, out_embed_dim=24, num_mel_bins=36,
            target_len=46)


@pytest.fixture(scope="module")
def tiny():
    jcfg = ji.ImageBindAudioConfig(**TINY)
    model = ji.ImageBindAudioEncoder(jcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, jcfg.num_mel_bins, jcfg.target_len)))["params"]
    params = fill_flax(shapes, 20)
    cfg = ti.ImageBindAudioConfig(**TINY)
    return jcfg, params, cfg, ti.state_dict_from_flax(cfg, params), model


def test_bias_kv_attention_is_torch_multihead_attention():
    """The port's attention takes ``nn.MultiheadAttention(add_bias_kv=True)``'s
    state dict as it is and gives its output (batch first)."""
    torch.manual_seed(0)
    mha = torch.nn.MultiheadAttention(16, 4, bias=True, add_bias_kv=True).eval()
    attn = ti._BiasKVAttention(ti.ImageBindAudioConfig(**TINY))
    attn.load_state_dict(mha.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(21).normal(size=(2, 5, 16)).astype(np.float32))
    with torch.no_grad():
        ref, _ = mha(x.transpose(0, 1), x.transpose(0, 1), x.transpose(0, 1))
        close(attn(x).numpy(), ref.transpose(0, 1).numpy(), 2e-5)


def test_encoder_from_flax_weights_matches_jax_on_a_non_square_grid(tiny):
    """``convert_torch_state`` of the port's state dict gives the JAX tree
    back; embed and feature equal JAX's, and the embeddings have norm
    ``logit_scale``."""
    jcfg, params, cfg, sd, model = tiny
    assert cfg.grid == (3, 4)
    assert_trees_equal(ji.convert_torch_state(jcfg, sd), params)
    enc = ti.ImageBindAudioEncoder(cfg)
    enc.load_state_dict(sd, strict=True)
    mels = np.random.default_rng(22).normal(size=(3, 36, 46)).astype(np.float32)
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(mels))
    want = jax.jit(lambda p, m: model.apply({"params": p}, m))(params, jnp.asarray(mels))
    for key in ("embed", "feature"):
        close(got[key].numpy(), want[key])
    np.testing.assert_allclose(np.linalg.norm(got["embed"].numpy(), axis=-1), 20.0, rtol=1e-5)


def test_patch_tokens_are_mel_row_major():
    """A patch-sum stem on a mel image lit in one patch lights token
    ``row * grid_cols + col`` (JAX's NHWC reshape order)."""
    cfg = ti.ImageBindAudioConfig(**TINY)
    stem = ti.ImageBindAudioEncoder(cfg).modality_preprocessors["audio"].rgbt_stem.proj
    with torch.no_grad():
        stem.weight.fill_(1.0)
        for r, c in ((0, 3), (2, 1)):
            mel = torch.zeros(1, 1, 36, 46)
            mel[0, 0, r * 10 + 7, c * 10 + 7] = 1.0     # only patch (r, c) covers it
            tokens = stem(mel).flatten(2).transpose(1, 2)[0, :, 0]
            assert tokens.nonzero().flatten().tolist() == [r * cfg.grid[1] + c]


def test_checkpoint_audio_subtree_is_selected():
    """``from_imagebind_checkpoint`` keeps the huge audio subtree's keys and
    leaves out the other modalities and the postprocessor's logit scale."""
    cfg = ti.ImageBindAudioConfig()
    with torch.device("meta"):
        keys = list(ti.ImageBindAudioEncoder(cfg).state_dict())
    sd = {k: torch.zeros(1) for k in keys}
    sd["modality_trunks.vision.blocks.0.attn.in_proj_weight"] = torch.zeros(1)
    sd["modality_postprocessors.audio.1.log_logit_scale"] = torch.zeros(1)
    got_cfg, got = ti.from_imagebind_checkpoint(sd)
    assert got_cfg == cfg and sorted(got) == sorted(keys)
    assert len(keys) == 5 + 3 + 12 * 14
    del sd["modality_heads.audio.2.weight"]
    with pytest.raises(KeyError, match="imagebind audio"):
        ti.from_imagebind_checkpoint(sd)


def test_extractor_matches_jax(tiny):
    """Two videos a batch: 3.1, 0.75 (padded to 2 s: eight equal clips) and
    5.6 s; FRA (8 clips each) and UTT (their mean)."""
    jcfg, params, cfg, sd, _ = tiny
    rng = np.random.default_rng(23)
    wavs = {n: (0.1 * rng.normal(size=L)).astype(np.float32)
            for n, L in (("a", 50000), ("b", 12000), ("c", 90000))}
    want = jfa.ImageBindAudioExtractor(jcfg, params, batch_clips=2)
    got = tfa.ImageBindAudioExtractor(cfg, sd, batch_clips=2, device="cpu")
    for level in ("FRA", "UTT"):
        assert_feats_close(got.extract(wavs, level), want.extract(wavs, level))
    fra = got.extract(wavs, "FRA")
    assert fra["a"].shape == (8, 24)
    close(fra["b"][7], fra["b"][0], 1e-6)
