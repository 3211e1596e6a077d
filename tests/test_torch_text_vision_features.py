"""The port's TextExtractor and VisionExtractor against the JAX package's on
tiny encoders (BERT 4 layers, CLIP 2 layers at 32 px) from the same Flax
params and the same numpy inputs, fp32 on the CPU within 1e-4: buckets,
truncation at the last bucket, empty spans, the token-span probe, frame
resampling, FRA and UTT; and both extractors default to the card."""

import dataclasses

import numpy as np
import pytest
import torch

from mertools_tpu.encoders import bert as jb
from mertools_tpu.encoders import vit_clip as jc
from mertools_tpu.features import text as jt
from mertools_tpu.features import vision as jvis
from mertools_tpu_torch.encoders import bert as tb
from mertools_tpu_torch.encoders import vit_clip as tc
from mertools_tpu_torch.features import text as tt
from mertools_tpu_torch.features import vision as tvis

torch.set_num_threads(1)

TOL = 1e-4
_MODELS = {}


def _bert():
    if "bert" not in _MODELS:
        import transformers as tr

        cfg = tr.BertConfig(hidden_size=16, num_hidden_layers=4,
                            num_attention_heads=2, intermediate_size=32,
                            vocab_size=60, max_position_embeddings=64)
        torch.manual_seed(0)
        jcfg, params = jb.from_hf_torch(tr.BertModel(cfg).eval())
        tcfg = tb.BertConfig(**dataclasses.asdict(jcfg))
        _MODELS["bert"] = (jcfg, params, tcfg, tb.state_dict_from_flax(tcfg, params))
    return _MODELS["bert"]


def _clip():
    if "clip" not in _MODELS:
        import transformers as tr

        cfg = tr.CLIPVisionConfig(hidden_size=32, num_hidden_layers=2,
                                  num_attention_heads=2, intermediate_size=64,
                                  image_size=32, patch_size=8, projection_dim=24)
        torch.manual_seed(0)
        jcfg, params = jc.from_hf_torch(tr.CLIPVisionModelWithProjection(cfg).eval())
        tcfg = tc.CLIPVisionConfig(**dataclasses.asdict(jcfg))
        _MODELS["clip"] = (jcfg, params, tcfg, tc.state_dict_from_flax(tcfg, params))
    return _MODELS["clip"]


def _sentences():
    """[CLS]=2 ... [SEP]=3 framed token lists: every bucket of (8, 16), one
    past the last bucket (cut to 16), and an empty span."""
    rng = np.random.default_rng(0)
    toks = {f"s{i}": [2] + rng.integers(4, 60, size=int(n)).tolist() + [3]
            for i, n in enumerate([3, 7, 12, 1, 22, 5, 9, 14])}
    toks["empty"] = [2, 3]
    return toks


@pytest.mark.parametrize("flash", [False, True], ids=["inline", "flash"])
@pytest.mark.parametrize("level", ["FRA", "UTT"])
def test_text_extractor_matches_jax(level, flash):
    jcfg, params, tcfg, sd = _bert()
    toks = _sentences()
    kw = dict(buckets=(8, 16), batch_size=3)
    if level not in _MODELS:    # JAX compiles per bucket: once a level
        _MODELS[level] = jt.TextExtractor(jcfg, params, **kw).extract(
            toks, span=(1, -1), level=level)
    ref = _MODELS[level]
    out = tt.TextExtractor(tcfg, sd, flash=flash, device="cpu", **kw).extract(
        toks, span=(1, -1), level=level)
    assert sorted(out) == sorted(ref)
    for name in toks:
        assert out[name].shape == ref[name].shape, name
        assert out[name].dtype == np.float32
        assert np.abs(out[name] - ref[name]).max() < TOL, name
    # the empty span is zeros; the long sentence was cut at the last bucket
    assert not out["empty"].any()
    assert out["s4"].shape[0] == (14 if level == "FRA" else 16)


class _CharTokenizer:
    """[CLS] + one id a character + [SEP], as BERT's Chinese vocab
    tokenizes; decode joins the characters with spaces."""

    def __call__(self, text):
        return {"input_ids": [101] + [ord(c) for c in text] + [102]}

    def decode(self, ids):
        return " ".join({101: "[CLS]", 102: "[SEP]"}.get(i, chr(i)) for i in ids)


class _NoSpecials(_CharTokenizer):
    def __call__(self, text):
        return {"input_ids": [ord(c) for c in text]}


def test_find_token_span_matches_jax():
    for tok, want in ((_CharTokenizer(), (1, -1)), (_NoSpecials(), (0, None))):
        assert tt.find_token_span(tok) == jt.find_token_span(tok) == want


def _faces():
    rng = np.random.default_rng(0)
    return {f"v{i}": rng.integers(0, 256, size=(t, 40, 40, 3)).astype(np.uint8)
            for i, t in enumerate([3, 5, 12, 1])}


@pytest.mark.parametrize("flash", [False, True], ids=["inline", "flash"])
@pytest.mark.parametrize("level", ["FRA", "UTT"])
def test_vision_extractor_matches_jax(level, flash):
    jcfg, params, tcfg, sd = _clip()
    faces = _faces()
    ref = jvis.VisionExtractor(jcfg, params, batch_size=4, max_frames=8
                               ).extract(faces, level=level)
    out = tvis.VisionExtractor(tcfg, sd, batch_size=4, max_frames=8,
                               flash=flash, device="cpu").extract(faces, level=level)
    assert sorted(out) == sorted(ref)
    for name in faces:
        assert out[name].shape == ref[name].shape, name
        assert np.abs(out[name] - ref[name]).max() < TOL, name
    if level == "FRA":     # 12 frames resampled to max_frames
        assert out["v2"].shape == (8, 24)


def test_resample_frames_uniform_matches_jax():
    for n, m in ((5, 8), (100, 10), (64, 64), (65, 64), (250, 64), (1, 64)):
        np.testing.assert_array_equal(tvis.resample_frames_uniform(n, m),
                                      jvis.resample_frames_uniform(n, m))


def test_extractors_default_to_the_card(monkeypatch):
    """No device: cuda, which raises on a host without a card instead of
    falling back to the CPU, in the int8 mode too (which builds on the CPU
    when asked); an unknown mode raises."""
    _, _, bcfg, bsd = _bert()
    _, _, ccfg, csd = _clip()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.TextExtractor(bcfg, bsd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvis.VisionExtractor(ccfg, csd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvis.VisionExtractor(ccfg, csd, compute_dtype="int8")
    assert tvis.VisionExtractor(ccfg, csd, compute_dtype="int8", device="cpu")._dtype == (
        torch.bfloat16)
    with pytest.raises(ValueError, match="compute_dtype 'int4'"):
        tvis.VisionExtractor(ccfg, csd, compute_dtype="int4", device="cpu")
    with pytest.raises(ValueError, match="B1"):
        tvis.VisionExtractor(dataclasses.replace(ccfg, tome_r=2), csd,
                             flash=True, device="cpu")
