"""The port's ``AudioExtractor`` against the JAX package's, mirroring
tests/test_feature_extraction.py: bucketed batches with zero-length filler
rows, multi-segment clips (max_segment=400), FRA and UTT, the f32 and int16
wires — fp32 within 1e-3, bf16 within 3% — with the same Flax params
carried across by ``state_dict_from_flax``."""

import dataclasses

import numpy as np
import pytest
import torch

from mertools_tpu.encoders import wav2vec2 as jw
from mertools_tpu.features import audio as ja
from mertools_tpu_torch.encoders import wav2vec2 as tw
from mertools_tpu_torch.features import audio as ta
from mertools_tpu_torch.ops.flash_attention import flash_attention

torch.set_num_threads(1)

KW = dict(max_segment=400, buckets=(128, 256, 400), sample_budget=1600)
LENGTHS = [150, 290, 400, 555, 1333, 80]


def _models(kind="base-style"):
    from transformers import HubertConfig, HubertModel

    large = kind == "large-style"
    cfg = HubertConfig(
        hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
        intermediate_size=48, conv_dim=(16, 16), conv_kernel=(10, 3),
        conv_stride=(5, 2), num_feat_extract_layers=2,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2,
        feat_extract_norm="layer" if large else "group",
        do_stable_layer_norm=large, conv_bias=large)
    torch.manual_seed(0)
    jcfg, params = jw.from_hf_torch(HubertModel(cfg).eval())
    tcfg = tw.Wav2Vec2Config(**dataclasses.asdict(jcfg))
    return jcfg, params, tcfg, tw.state_dict_from_flax(tcfg, params)


def _wavs(seed=0, int16=False):
    rng = np.random.default_rng(seed)
    if int16:
        return {f"c{i}": (rng.normal(size=L) * 3000).astype(np.int16)
                for i, L in enumerate(LENGTHS)}
    return {f"clip{i}": rng.normal(size=L).astype(np.float32)
            for i, L in enumerate(LENGTHS)}


def _assert_close(got, ref, tol, rel=False):
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        err = np.abs(got[name] - ref[name]).max()
        if rel:
            err /= np.abs(ref[name]).max()
        assert err < tol, (name, err)


@pytest.mark.parametrize("kind", ["base-style", "large-style"])
@pytest.mark.parametrize("wire", ["f32", "int16"])
@pytest.mark.parametrize("level", ["FRA", "UTT"])
def test_extractor_matches_jax(kind, wire, level):
    jcfg, params, tcfg, sd = _models(kind)
    wavs = _wavs(int16=wire == "int16")
    ref = ja.AudioExtractor(jcfg, params, transfer_dtype=wire,
                            **KW).extract(wavs, level=level)
    got = ta.AudioExtractor(tcfg, sd, transfer_dtype=wire, device="cpu",
                            **KW).extract(wavs, level=level)
    _assert_close(got, ref, 1e-3)
    if level == "FRA":  # multi-segment clips keep the padded tail's frames
        assert got["c4" if wire == "int16" else "clip4"].shape[0] == 4 * 39


def test_flash_on_cpu_equals_plain():
    """flash=True routes attention through flash_attention, which takes the
    plain version for CPU tensors (and launches nothing)."""
    _, _, tcfg, sd = _models()
    wavs = _wavs(1)
    plain = ta.AudioExtractor(tcfg, sd, device="cpu", **KW)
    flash = ta.AudioExtractor(tcfg, sd, device="cpu", flash=True, **KW)
    assert flash.cfg.use_flash_attention and not plain.cfg.use_flash_attention
    before = flash_attention.launches
    _assert_close(flash.extract(wavs, level="FRA"),
                  plain.extract(wavs, level="FRA"), 1e-5)
    assert flash_attention.launches == before


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_bf16_within_3pct_of_jax_fp32(flash):
    jcfg, params, tcfg, sd = _models("large-style")
    wavs = _wavs(2)
    ref = ja.AudioExtractor(jcfg, params, **KW).extract(wavs, level="UTT")
    got = ta.AudioExtractor(tcfg, sd, compute_dtype="bf16", flash=flash,
                            device="cpu", **KW).extract(wavs, level="UTT")
    _assert_close(got, ref, 0.03, rel=True)


def test_reference_single_clip_matches_jax():
    jcfg, params, tcfg, sd = _models()
    rng = np.random.default_rng(3)
    for L in (333, 950):
        wav = rng.normal(size=L).astype(np.float32)
        ref = ja.reference_single_clip(jcfg, params, wav, max_segment=400)
        got = ta.reference_single_clip(tcfg, sd, wav, max_segment=400)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() < 1e-3


def test_segmentize_matches_jax():
    w = np.random.default_rng(4).normal(size=1333).astype(np.float32)
    for a, b in zip(ta.segmentize(w, 400), ja.segmentize(w, 400)):
        assert a[1] == b[1] and np.array_equal(a[0], b[0])
    w16 = (w * 3000).astype(np.int16)
    for a, b in zip(ta.segmentize_i16(w16, 400), ja.segmentize_i16(w16, 400)):
        assert a[1:] == b[1:] and np.array_equal(a[0], b[0])
    assert np.array_equal(ta.normalize_wav(w), ja.normalize_wav(w))
    assert ta.DEFAULT_BUCKETS == ja.DEFAULT_BUCKETS


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, _, tcfg, sd = _models()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.AudioExtractor(tcfg, sd, device="cuda")


@pytest.mark.parametrize("kw,exc", [
    (dict(compute_dtype="int8"), NotImplementedError),
    (dict(compute_dtype="fp8"), ValueError),
    (dict(transfer_dtype="u8"), ValueError),
])
def test_unsupported_modes_raise(kw, exc):
    _, _, tcfg, sd = _models()
    with pytest.raises(exc):
        ta.AudioExtractor(tcfg, sd, device="cpu", **kw)
