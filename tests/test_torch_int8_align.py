"""The int8 extraction mode and the device half of ``ops/align.py`` against
the JAX package's on the CPU.

int8 (``compute_dtype="int8"``): bf16 params and activations with dynamic
w8a8 products (``ops/quant.int8_dot_general``) at the transformer layers'
Dense sites only, in ``AudioExtractor`` and ``VisionExtractor``, from the
same Flax params and inputs as the JAX extractors' int8 mode: UTT within
``INT8_TOL`` of max|jax int8| (two bf16 computations that round apart, and
codes that can move by one where they do), and the sites themselves
counted. ``ops/align``'s ``map_feature_batched``, ``masked_mean_over_time``
and ``scale_compress_batched``: the weight matrices equal and the outputs
within 1e-6 of the JAX functions' (fp32 products)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.encoders import vit_clip as jc
from mertools_tpu.features import audio as ja
from mertools_tpu.features import vision as jvis
from mertools_tpu.ops import align as j_align
from mertools_tpu_torch.encoders import vit_clip as tc
from mertools_tpu_torch.encoders import wav2vec2 as tw
from mertools_tpu_torch.features import audio as ta
from mertools_tpu_torch.features import vision as tvis
from mertools_tpu_torch.ops import align as t_align
from mertools_tpu_torch.ops import quant

from test_torch_audio import KW, _models

torch.set_num_threads(1)

INT8_TOL = 2e-2   # port int8 vs JAX int8, UTT, max |port - jax| / max |jax|
ALIGN_TOL = 1e-6  # device align vs JAX, max |port - jax| / max |jax|


def _rel(got: dict, ref: dict) -> float:
    assert got.keys() == ref.keys()
    return max(float(np.abs(got[n] - ref[n]).max() / np.abs(ref[n]).max()) for n in ref)


def test_audio_int8_matches_jax_int8():
    """Clips of one bucket (one JAX compile): the port's int8 against JAX's
    int8, and against the port's fp32 (an approximation, not a copy)."""
    jcfg, params, tcfg, sd = _models("large-style")
    rng = np.random.default_rng(5)
    wavs = {f"c{i}": rng.normal(size=L).astype(np.float32) for i, L in enumerate((300, 390))}
    ref = ja.AudioExtractor(jcfg, params, compute_dtype="int8", **KW).extract(wavs, "UTT")
    got = ta.AudioExtractor(tcfg, sd, compute_dtype="int8", device="cpu", **KW).extract(
        wavs, "UTT")
    fp32 = ta.AudioExtractor(tcfg, sd, device="cpu", **KW).extract(wavs, "UTT")
    assert _rel(got, ref) <= INT8_TOL
    assert 0 < _rel(got, fp32) <= 2 * INT8_TOL


def test_vision_int8_matches_jax_int8():
    import transformers as tr

    hf = tr.CLIPVisionConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=64, image_size=32, patch_size=8,
                             projection_dim=24)
    torch.manual_seed(0)
    jcfg, params = jc.from_hf_torch(tr.CLIPVisionModelWithProjection(hf).eval())
    tcfg = tc.CLIPVisionConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(6)
    faces = {f"c{i}": rng.integers(0, 256, (t, 40, 40, 3)).astype(np.uint8)
             for i, t in enumerate((3, 9, 5))}
    ref = jvis.VisionExtractor(jcfg, params, batch_size=4, compute_dtype="int8").extract(
        faces, "UTT")
    got = tvis.VisionExtractor(tcfg, tc.state_dict_from_flax(tcfg, params), batch_size=4,
                               compute_dtype="int8", device="cpu").extract(faces, "UTT")
    assert _rel(got, ref) <= INT8_TOL


def test_int8_hook_sits_on_the_transformer_dense_sites_only():
    """Six sites a layer (q/k/v/out and the feed-forward or MLP pair): the
    conv frontend, the feature and visual projections and the positional
    conv stay float, as in the JAX encoders."""
    calls = []

    def recording(lhs, rhs):
        calls.append(tuple(rhs.shape))
        return quant.int8_dot_general(lhs, rhs)

    _, _, tcfg, sd = _models("large-style")
    enc = tw.Wav2Vec2Encoder(tcfg, dot_general=recording)
    enc.load_state_dict(sd)
    with torch.no_grad():
        enc(torch.zeros(2, 800))
    H, F = tcfg.hidden_size, tcfg.intermediate_size
    assert calls == ([(H, H)] * 4 + [(H, F), (F, H)]) * tcfg.num_hidden_layers
    calls.clear()
    vcfg = tc.CLIPVisionConfig(hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                               intermediate_size=32, image_size=32, patch_size=16,
                               projection_dim=12)
    venc = tc.CLIPVisionEncoder(vcfg, dot_general=recording)
    with torch.no_grad():
        venc(torch.zeros(1, 32, 32, 3))
    assert calls == ([(16, 16)] * 4 + [(16, 32), (32, 16)]) * 2
    quant.set_dot_general(venc, None)            # cleared: nn.Linear again
    calls.clear()
    with torch.no_grad():
        venc(torch.zeros(1, 32, 32, 3))
    assert calls == []


@pytest.mark.parametrize("dst", [3, 7, 16])
def test_map_feature_batched_matches_jax(dst):
    rng = np.random.default_rng(dst)
    lengths = np.array([3, 7, 16, 25, 1, 0], np.int32)
    x = rng.normal(size=(len(lengths), 32, 6)).astype(np.float32)
    w = t_align._mapping_weights(torch.from_numpy(lengths), 32, dst).numpy()
    np.testing.assert_array_equal(
        w, np.asarray(j_align._mapping_weights(jnp.asarray(lengths), 32, dst)))
    got = t_align.map_feature_batched(torch.from_numpy(x), torch.from_numpy(lengths), dst)
    ref = np.asarray(j_align.map_feature_batched(jnp.asarray(x), jnp.asarray(lengths), dst))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= ALIGN_TOL * np.abs(ref).max()
    for i, L in enumerate(lengths[:-1]):      # the host half on each row
        np.testing.assert_allclose(got[i].numpy(), t_align.map_feature_np(x[i, :L], dst),
                                   atol=1e-6)


def test_masked_mean_and_scale_compress_match_jax():
    rng = np.random.default_rng(8)
    lengths = np.array([4, 12, 23, 1], np.int32)
    x = rng.normal(size=(4, 24, 5)).astype(np.float32)
    x[0, 4:] = 99.0                              # padding is never read
    got = t_align.masked_mean_over_time(torch.from_numpy(x), torch.from_numpy(lengths))
    ref = np.asarray(j_align.masked_mean_over_time(jnp.asarray(x), jnp.asarray(lengths)))
    assert np.abs(got.numpy() - ref).max() <= ALIGN_TOL * np.abs(ref).max()
    for scale in (1, 6):
        y, n = t_align.scale_compress_batched(torch.from_numpy(x), torch.from_numpy(lengths),
                                              scale, 24)
        ry, rn = j_align.scale_compress_batched(jnp.asarray(x), jnp.asarray(lengths),
                                                scale, 24)
        np.testing.assert_array_equal(n.numpy(), np.asarray(rn))
        assert np.abs(y.numpy() - np.asarray(ry)).max() <= ALIGN_TOL * np.abs(ry).max()
        host = t_align.feature_scale_compress_np([x[i, :L] for i, L in enumerate(lengths)],
                                                 scale)
        for i, h in enumerate(host):
            np.testing.assert_allclose(y[i, : len(h)].numpy(), h, atol=1e-6)
            assert not y[i, len(h):].any()
