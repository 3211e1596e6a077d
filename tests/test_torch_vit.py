"""The port's ViT family (``mertools_tpu_torch/encoders/vit.py``: DINOv2 with
and without SwiGLU, BEiT / data2vec-vision, VideoMAE, EVA-CLIP-G, EVA-02)
and SigLIP tower (``encoders/siglip.py``, the pooling head included)
against the JAX package's modules on tiny configs: the same Flax params
(``jax.eval_shape`` trees filled by numpy) carried across by
``state_dict_from_flax``, the same numpy pixels, fp32 within 2e-4 of max.
Token Merging and Flax's SAME padding: ``test_torch_vit_tome.py``. One
jitted JAX forward a case, built once a module."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mertools_tpu.encoders import siglip as js
from mertools_tpu.encoders import vit as jv
from mertools_tpu_torch.encoders import siglip as ts
from mertools_tpu_torch.encoders import vit as tv
from test_torch_audio_zoo import close, fill_flax

torch.set_num_threads(1)

TINY = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=48)
# family -> (JAX config, input shape)
FAMILIES = {
    "dinov2": (jv.dinov2_config(**TINY, image_size=56), (2, 56, 56, 3)),
    "dinov2_swiglu": (jv.dinov2_config(**TINY, image_size=28, use_swiglu=True),
                      (2, 28, 28, 3)),
    "beit": (jv.beit_config(**TINY, image_size=32), (2, 32, 32, 3)),
    "videomae": (jv.videomae_config(**TINY, image_size=32, num_frames=4),
                 (2, 4, 32, 32, 3)),
    "eva_clip_g": (jv.eva_clip_g_config(**TINY, image_size=56), (2, 56, 56, 3)),
    "eva02": (jv.eva02_config(**TINY, image_size=28), (2, 28, 28, 3)),
    # not a published family: Flax pads SAME, 30 px over patch 8 -> 4 x 4
    "same_pad": (jv.ViTConfig(**TINY, image_size=30, patch_size=8, pos_embed="none"),
                 (2, 30, 30, 3)),
    "siglip": (js.SiglipVisionConfig(hidden_size=32, num_layers=2, num_heads=4,
                                     intermediate_size=48, image_size=28, patch_size=7),
               (2, 28, 28, 3)),
}
_PARAMS = {}


def _flax(family: str, seed: int = 0):
    """(JAX module class, Flax params, numpy input) of a family, once."""
    if family not in _PARAMS:
        jcfg, shape = FAMILIES[family]
        cls = js.SiglipVisionEncoder if family == "siglip" else jv.ViTEncoder
        x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
        shapes = jax.eval_shape(cls(jcfg).init, jax.random.PRNGKey(0), jnp.asarray(x))
        _PARAMS[family] = (cls, fill_flax(shapes["params"], seed), x)
    return _PARAMS[family]


def _port(family: str, jcfg, params):
    """The port's module of ``jcfg`` (its fields) on ``params``."""
    if family == "siglip":
        cfg = ts.SiglipVisionConfig(**dataclasses.asdict(jcfg))
        m = ts.SiglipVisionEncoder(cfg)
        m.load_state_dict(ts.state_dict_from_flax(cfg, params), strict=True)
    else:
        cfg = tv.ViTConfig(**dataclasses.asdict(jcfg))
        m = tv.ViTEncoder(cfg)
        m.load_state_dict(tv.state_dict_from_flax(cfg, params), strict=True)
    return m.eval()


@functools.lru_cache(maxsize=None)
def _jax_apply(jcfg):
    """The JAX module's jitted forward, compiled once a config."""
    cls = js.SiglipVisionEncoder if isinstance(jcfg, js.SiglipVisionConfig) else jv.ViTEncoder
    return jax.jit(lambda p, v: cls(jcfg).apply({"params": p}, v))


def _both(family: str, jcfg, params, x):
    """(JAX output, port output) as dicts of numpy arrays."""
    ref = _jax_apply(jcfg)(params, jnp.asarray(x))
    with torch.no_grad():
        out = _port(family, jcfg, params)(torch.from_numpy(x))
    if family == "siglip":
        return ({k: np.asarray(v) for k, v in ref.items()},
                {k: v.numpy() for k, v in out.items()})
    tokens, sizes = out
    ref = ref if jcfg.tome_r else (ref, None)
    return ({"tokens": np.asarray(ref[0]), "sizes": ref[1]},
            {"tokens": tokens.numpy(), "sizes": None if sizes is None else sizes.numpy()})


@pytest.mark.parametrize("family", ["dinov2", "beit", "videomae", "eva_clip_g", "eva02",
                                    "siglip"])
def test_encoder_matches_jax(family):
    """Every output of the module, from the same Flax params (BEiT's
    relative bias tables, LayerScale and the norms drawn, not at their
    init), within 2e-4 of max in fp32; DINOv2 also with the SwiGLU MLP of
    dinov2-giant."""
    for case in (family, "dinov2_swiglu")[: 2 if family == "dinov2" else 1]:
        _, params, x = _flax(case)
        ref, out = _both(case, FAMILIES[case][0], params, x)
        assert sorted(k for k in out if out[k] is not None) == sorted(
            k for k in ref if ref[k] is not None)
        for key in out:
            if out[key] is not None:
                close(out[key], ref[key])
