"""The port's vision-zoo extractors (``mertools_tpu_torch/features/
vision_zoo.py``) against the JAX package's on tiny towers from the same
Flax params and the same seeded 112 x 112 uint8 face crops, at FRA and UTT
within 2e-4 of max (fp32, CPU): DINOv2's 64-frame resample and token sum,
data2vec's every frame, EVA-CLIP-G's ``ln_vision`` token mean, SigLIP's
token mean, the size-weighted pools under ToMe, VideoMAE's repeat-pad,
resample and segments; bf16 against fp32; an empty clip refused. Batches
are small, so pad rows reach the scrap slot."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mertools_tpu.encoders import siglip as js
from mertools_tpu.encoders import vit as jv
from mertools_tpu.features import vision_zoo as jz
from mertools_tpu_torch.encoders import siglip as ts
from mertools_tpu_torch.encoders import vit as tv
from mertools_tpu_torch.features import vision_zoo as tz
from test_torch_audio_zoo import close, fill_flax

torch.set_num_threads(1)

TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=48)
CONFIGS = {
    "dinov2": jv.dinov2_config(**TINY, image_size=28),
    "beit": jv.beit_config(**TINY, image_size=32),
    "eva_clip_g": jv.eva_clip_g_config(**TINY, image_size=28),
    "siglip": js.SiglipVisionConfig(**TINY, image_size=28, patch_size=7),
    "videomae": jv.videomae_config(**TINY, image_size=32, num_frames=4),
}
_PARAMS = {}


def _params(family: str):
    """(Flax params, the port's state dict) of a family, once."""
    if family not in _PARAMS:
        jcfg = CONFIGS[family]
        siglip = family == "siglip"
        cls = js.SiglipVisionEncoder if siglip else jv.ViTEncoder
        shape = ((1, jcfg.num_frames, jcfg.image_size, jcfg.image_size, 3)
                 if family == "videomae" else (1, jcfg.image_size, jcfg.image_size, 3))
        p = fill_flax(jax.eval_shape(cls(jcfg).init, jax.random.PRNGKey(0),
                                     jnp.zeros(shape))["params"], 0)
        tcfg = _port_cfg(jcfg)
        _PARAMS[family] = (p, (ts if siglip else tv).state_dict_from_flax(tcfg, p))
    return _PARAMS[family]


def _port_cfg(jcfg):
    cls = ts.SiglipVisionConfig if isinstance(jcfg, js.SiglipVisionConfig) else tv.ViTConfig
    return cls(**dataclasses.asdict(jcfg))


def _faces(seed: int, lengths) -> dict:
    rng = np.random.default_rng(seed)
    return {f"c{i}": rng.integers(0, 256, (n, 112, 112, 3), np.uint8)
            for i, n in enumerate(lengths)}


def _extractors(case: str, tome: int = 0, **port_kw):
    """(JAX extractor, port extractor) of a case on the same weights."""
    family = case.split("-")[0]
    p, sd = _params(family)
    jcfg = dataclasses.replace(CONFIGS[family], tome_r=tome)
    tcfg = _port_cfg(jcfg)
    kw = dict(device="cpu", **port_kw)
    if family in ("dinov2", "beit"):
        return (jz.vit_token_sum_extractor(jcfg, p, batch_size=16),
                tz.vit_token_sum_extractor(tcfg, sd, batch_size=16, **kw))
    if family == "eva_clip_g":
        ln = None
        if case.endswith("ln_vision"):
            rng = np.random.default_rng(9)
            ln = {"scale": 1 + 0.2 * rng.normal(size=32).astype(np.float32),
                  "bias": 0.2 * rng.normal(size=32).astype(np.float32)}
        return (jz.eva_clip_g_token_mean_extractor(jcfg, p, ln_vision=ln, batch_size=8,
                                                   max_frames=12),
                tz.eva_clip_g_token_mean_extractor(tcfg, sd, ln_vision=ln, batch_size=8,
                                                   max_frames=12, **kw))
    if family == "siglip":
        return (jz.siglip_token_mean_extractor(jcfg, p, batch_size=8, max_frames=12),
                tz.siglip_token_mean_extractor(tcfg, sd, batch_size=8, max_frames=12, **kw))
    return (jz.VideoMAEExtractor(jcfg, p, batch_size=2),
            tz.VideoMAEExtractor(tcfg, sd, batch_size=2, **kw))


# case -> (ToMe r, clip lengths): DINOv2 resamples the 70-frame clip to 64,
# EVA-G and SigLIP a 20-frame one to 12, data2vec keeps every frame
FRAME_CASES = {"dinov2": (0, (70, 3)), "dinov2-tome": (2, (70, 3)), "beit": (0, (9, 5)),
               "eva_clip_g-ln_vision": (0, (20, 5)), "eva_clip_g-tome": (2, (20, 5)),
               "siglip": (0, (20, 5)), "siglip-tome": (3, (20, 5))}


@pytest.mark.parametrize("family", ["dinov2", "beit", "eva_clip_g", "siglip"])
def test_frame_extractors_match_jax(family):
    """Each case of the family (plain, ToMe, EVA-G's ``ln_vision``) at FRA
    and UTT; data2vec also refuses an empty clip, as JAX does."""
    for case in (c for c in FRAME_CASES if c.split("-")[0] == family):
        tome, lengths = FRAME_CASES[case]
        jex, tex = _extractors(case, tome)
        faces = _faces(len(case), lengths)
        for level in ("FRA", "UTT"):
            want, got = jex.extract(faces, level=level), tex.extract(faces, level=level)
            assert list(got) == list(want)
            for n in want:
                close(got[n], want[n])
        rows = {"dinov2": 64, "beit": 9}.get(family, 12)
        assert got["c0"].shape == (32,) and want["c0"].ndim == 1
        assert tex.extract(faces, level="FRA")["c0"].shape == (rows, 32)
    if family == "beit":
        faces = {"ok": faces["c0"], "empty": np.zeros((0, 112, 112, 3), np.uint8)}
        for ex in (jex, tex):
            with pytest.raises(ValueError, match="no frames"):
                ex.extract(faces, level="UTT")


def test_videomae_extractor_matches_jax():
    """Clips of 2 and 3 frames repeat-padded by ``np.resize`` to the tower's
    4, one of 10 resampled; 3 clips in batches of 2 (a zero pad clip); FRA
    is (segments, D), UTT their mean."""
    jex, tex = _extractors("videomae")
    faces = _faces(7, (2, 10, 3))
    for level in ("FRA", "UTT"):
        want, got = jex.extract(faces, level=level), tex.extract(faces, level=level)
        assert list(got) == list(want)
        for n in want:
            close(got[n], want[n])
    assert got["c0"].shape == (32,) and tex.extract(faces, "FRA")["c1"].shape == (2, 32)


def test_bf16_is_near_fp32():
    """bf16 parameters and activations (fp32 preprocessing): UTT within 3%
    of max of fp32, the extraction gate of the card phases."""
    faces = _faces(11, (6, 4))
    for case in ("dinov2", "eva_clip_g-ln_vision", "siglip", "videomae"):
        _, f32 = _extractors(case)
        _, bf16 = _extractors(case, compute_dtype="bf16")
        assert next(bf16.model.parameters()).dtype == torch.bfloat16
        want, got = f32.extract(faces, level="UTT"), bf16.extract(faces, level="UTT")
        for n in want:
            close(got[n], want[n], tol=3e-2)
