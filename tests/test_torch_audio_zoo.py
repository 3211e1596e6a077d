"""The port's VGGish and wav2vec 1.0 (``mertools_tpu_torch/encoders/
audio_zoo.py``, their extractors in ``features/audio.py``) against the JAX
package's: the VGGish frontend at several lengths (shorter than one frame
and one patch included), each encoder from ``*_state_dict_from_flax``
weights, the JAX converters' round trip, wav2vec 1.0's pad invariance, and
each extractor's trimming and truncation, on seeded inputs. One jitted JAX
forward a model, built once a module."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mertools_tpu.encoders import audio_zoo as jz
from mertools_tpu.features import audio as jfa
from mertools_tpu_torch.encoders import audio_zoo as tz
from mertools_tpu_torch.features import audio as tfa

torch.set_num_threads(1)

TOL = 2e-4   # max |port - JAX| / max |JAX| (ROADMAP "Tolerances")
W2V1_TINY = dict(enc_layers=((32, 10, 5), (32, 8, 4)), ctx_layers=((32, 3), (32, 3)))


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, (err, scale)


def fill_flax(shapes, seed: int):
    """A Flax param tree of ``shapes`` (``jax.eval_shape`` of an init) with
    seeded numpy leaves: norm scales 1 + 0.1 n, vectors 0.1 n, kernels and
    tables n / sqrt(fan_in) (fan_in: every axis but the last)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(s.shape, dtype=np.float32)
        if name in ("scale", "norm_scale"):
            return 1.0 + 0.1 * n
        if len(s.shape) == 1:
            return 0.1 * n
        return n / np.float32(math.sqrt(math.prod(s.shape[:-1])))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def assert_feats_close(got: dict, want: dict, tol=TOL):
    assert sorted(got) == sorted(want)
    for n in want:
        close(got[n], want[n], tol)


# ------------------------------------------------------------------ VGGish


@pytest.fixture(scope="module")
def vggish():
    shapes = jax.eval_shape(jz.VGGish().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 96, 64)))["params"]
    params = fill_flax(shapes, 0)
    fwd = jax.jit(lambda p, x: jz.VGGish().apply({"params": p}, x))
    return params, tz.vggish_state_dict_from_flax(params), fwd


@pytest.mark.parametrize("n", [300, 7000, 16000, 32000, 47000])
def test_vggish_log_mel_patches_match_jax(n):
    """Frames ``max(1 + (n - 400) // 160, 1)`` (a clip under one frame reads
    its last sample again, as JAX's clamped gather does), patches
    ``max(frames // 96, 1)``, short clips zero-padded to one patch."""
    w = (np.random.default_rng(n).normal(size=(2, n)) * 0.1).astype(np.float32)
    got = tz.vggish_log_mel_patches(torch.from_numpy(w)).numpy()
    want = np.asarray(jax.jit(jz.vggish_log_mel_patches)(jnp.asarray(w)))
    assert got.shape == (2, tz.vggish_patches(n), 96, 64)
    close(got, want)


def test_vggish_tables_equal_jax():
    np.testing.assert_array_equal(tz.vggish_mel_matrix(), jz.vggish_mel_matrix())
    n = np.array([1, 399, 400, 4000, 31999, 320000])
    np.testing.assert_array_equal(tz.w2v1_out_lengths(n), jz.w2v1_out_lengths(n))
    cfg = tz.Wav2Vec1Config(**W2V1_TINY)
    np.testing.assert_array_equal(tz.w2v1_out_lengths(n, cfg),
                                  jz.w2v1_out_lengths(n, jz.Wav2Vec1Config(**W2V1_TINY)))


def test_vggish_from_flax_weights_and_the_converter_round_trip(vggish):
    """torchvggish's key names; ``vggish_from_torch`` of the port's state
    dict gives the JAX tree back; the port's forward (NCHW convs, permuted
    to NHWC before the flatten) equals JAX's on seeded patches."""
    params, sd, fwd = vggish
    want_keys = sorted([f"features.{i}.{p}" for i in (0, 3, 6, 8, 11, 13)
                        for p in ("weight", "bias")]
                       + [f"embeddings.{i}.{p}" for i in (0, 2, 4) for p in ("weight", "bias")])
    assert sorted(sd) == want_keys
    assert_trees_equal(jz.vggish_from_torch(sd), params)
    model = tz.VGGish()
    model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(1).normal(size=(3, 96, 64)).astype(np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    close(got, np.asarray(fwd(params, jnp.asarray(x))))


def test_vggish_extractor_matches_jax_trimming_and_truncation(vggish, capsys):
    """Buckets (16000, 32000): one patch for 1 s and for 0.44 s (padded),
    two for 1.94 s, and a 2.5 s clip truncated to the last bucket with the
    warning; FRA keeps each clip's true patches, UTT is their mean."""
    params, sd, _ = vggish
    rng = np.random.default_rng(2)
    wavs = {n: (rng.normal(size=L) * 0.1).astype(np.float32)
            for n, L in (("a", 16000), ("b", 31000), ("c", 7000), ("d", 40000))}
    want = jfa.VGGishExtractor(params, buckets=(16000, 32000))
    got = tfa.VGGishExtractor(sd, buckets=(16000, 32000), device="cpu")
    for level in ("FRA", "UTT"):
        g, w = got.extract(wavs, level), want.extract(wavs, level)
        assert_feats_close(g, w)
    fra = got.extract(wavs, "FRA")
    assert {n: f.shape[0] for n, f in fra.items()} == {"a": 1, "b": 2, "c": 1, "d": 2}
    assert "clip 'd' is 40000 samples; truncating to 32000" in capsys.readouterr().out


# ------------------------------------------------------------- wav2vec 1.0


@pytest.fixture(scope="module")
def w2v1():
    jcfg = jz.Wav2Vec1Config(**W2V1_TINY)
    model = jz.Wav2Vec1(jcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4000)))["params"]
    params = fill_flax(shapes, 3)
    fwd = jax.jit(lambda p, w, n: model.apply({"params": p}, w, n))
    fwd_one = jax.jit(lambda p, w: model.apply({"params": p}, w))
    cfg = tz.Wav2Vec1Config(**W2V1_TINY)
    return jcfg, params, cfg, tz.wav2vec1_state_dict_from_flax(params, cfg), fwd, fwd_one


def test_wav2vec1_from_flax_weights_round_trip_and_pad_invariance(w2v1):
    """fairseq key names; ``wav2vec1_from_fairseq`` of the port's state dict
    gives the JAX tree back; a right-padded batch (masked instance norms)
    equals JAX's, and each row's valid frames equal the clip run alone in
    both packages (unmasked norms)."""
    jcfg, params, cfg, sd, fwd, fwd_one = w2v1
    assert sorted(sd) == sorted(
        f"feature_{part}.conv_layers.{i}.{j}.{p}"
        for part, n in (("extractor", 2), ("aggregator", 2)) for i in range(n)
        for j in (0, 2) for p in ("weight", "bias"))
    assert_trees_equal(jz.wav2vec1_from_fairseq(sd, jcfg), params)
    model = tz.Wav2Vec1(cfg)
    model.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(4)
    wavs = [rng.normal(size=L).astype(np.float32) for L in (3000, 4096)]
    batch = np.zeros((2, 4096), np.float32)
    for r, w in enumerate(wavs):
        batch[r, : len(w)] = w
    lens = np.array([3000, 4096], np.int32)
    with torch.no_grad():
        got = model(torch.from_numpy(batch), torch.from_numpy(lens))
        alone = model(torch.from_numpy(wavs[0][None]))
    want = fwd(params, jnp.asarray(batch), jnp.asarray(lens))
    want_alone = fwd_one(params, jnp.asarray(wavs[0][None]))
    n0 = int(tz.w2v1_out_lengths(3000, cfg))
    for key in ("z", "c"):
        close(got[key].numpy(), want[key])
        close(alone[key].numpy(), want_alone[key])
        close(got[key][0, :n0].numpy(), alone[key][0].numpy(), 1e-5)
    assert (got["z"].numpy() >= 0).all()             # log-compressed


def test_wav2vec1_extractor_matches_jax_trimming_and_truncation(w2v1, capsys):
    """Buckets (4000, 8000): z and c trimmed to ``w2v1_out_lengths``, FRA
    and UTT, with a 9000-sample clip truncated to 8000."""
    jcfg, params, cfg, sd, _, _ = w2v1
    rng = np.random.default_rng(5)
    wavs = {f"w{L}": (rng.normal(size=L) * 0.1).astype(np.float32)
            for L in (3000, 4000, 6500, 9000)}
    want = jfa.Wav2Vec1Extractor(params, jcfg, buckets=(4000, 8000))
    got = tfa.Wav2Vec1Extractor(sd, cfg, buckets=(4000, 8000), device="cpu")
    for level in ("FRA", "UTT"):
        for g, w in zip(got.extract_zc(wavs, level), want.extract_zc(wavs, level)):
            assert_feats_close(g, w)
    z, c = got.extract_zc(wavs, "FRA")
    for n, L in (("w3000", 3000), ("w6500", 6500), ("w9000", 8000)):
        assert z[n].shape == c[n].shape == (int(tz.w2v1_out_lengths(L, cfg)), 32)
    assert "truncating to 8000" in capsys.readouterr().out


@pytest.mark.parametrize("make", [
    lambda: tfa.VGGishExtractor({}), lambda: tfa.Wav2Vec1Extractor({}),
    lambda: tfa.Emotion2VecExtractor({}),
    lambda: tfa.ImageBindAudioExtractor(None, {})], ids=["vggish", "wav2vec1",
                                                          "emotion2vec", "imagebind"])
def test_zoo_extractors_default_to_the_card(make):
    """Each zoo extractor runs on ``cuda`` unless told otherwise, and on a
    host without a card it raises: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
