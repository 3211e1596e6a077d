"""Token Merging in the port's ViT family and SigLIP tower against the JAX
package's, from the same Flax params (``test_torch_vit``'s tiny configs):
tokens and sizes for each family that allows it, with ties ranked as
``tome_merge`` ranks them; its refusal with per-layer positional attention
(BEiT's relative bias, EVA-02's rope); Flax's SAME padding where the image
does not divide by the patch."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from mertools_tpu.encoders import vit as jv
from mertools_tpu_torch.encoders import vit as tv
from test_torch_audio_zoo import close
from test_torch_vit import FAMILIES, _both, _flax


@pytest.mark.parametrize("family", ["dinov2", "videomae", "eva_clip_g", "siglip"])
def test_tome_matches_jax(family):
    """ToMe r 2 (3 for SigLIP's 16 tokens): tokens and sizes as JAX's; then
    with zero k kernels, so every token's metric is the k bias, each A
    token's best B is the first and every score ties: the merge order is
    the stable argsort's."""
    _, params, x = _flax(family)
    jcfg = dataclasses.replace(FAMILIES[family][0], tome_r=3 if family == "siglip" else 2)
    k = "k_proj" if family == "siglip" else "k"
    tied = {n: {**p, k: {**p[k], "kernel": np.zeros_like(p[k]["kernel"])}}
            if n.startswith(("block_", "layer_")) else p for n, p in params.items()}
    for p in (params, tied):
        ref, out = _both(family, jcfg, p, x)
        for key in ("sizes", "last_hidden", "post_ln", "pooled") if family == "siglip" \
                else ("tokens", "sizes"):
            close(out[key], ref[key])
        # every merge keeps the sizes' sum: the tokens the tower started with
        n0 = {"dinov2": 17, "videomae": 8, "eva_clip_g": 17, "siglip": 16}[family]
        assert out["sizes"].sum(-1).tolist() == [n0] * 2 and out["sizes"].shape[1] < n0


def test_tome_is_refused_with_positional_attention():
    """BEiT's per-layer relative bias and EVA-02's rope change with the
    token set: the port's config refuses ToMe as the JAX block's assert
    does."""
    for family in ("beit", "eva02"):
        _, params, x = _flax(family)
        jcfg = dataclasses.replace(FAMILIES[family][0], tome_r=2)
        with pytest.raises(AssertionError, match="incompatible"):
            jv.ViTEncoder(jcfg).apply({"params": params}, jnp.asarray(x))
        with pytest.raises(ValueError, match="incompatible"):
            tv.ViTConfig(**dataclasses.asdict(jcfg))


def test_same_padding_where_the_image_does_not_divide_by_the_patch():
    """Flax's conv pads SAME: 30 px over patch 8 gives ceil(30 / 8)^2 = 16
    patches, the pad split low-half first; the port keeps that result."""
    _, params, x = _flax("same_pad")
    ref, out = _both("same_pad", FAMILIES["same_pad"][0], params, x)
    close(out["tokens"], ref["tokens"])
    assert out["tokens"].shape == (2, 1 + 16, 32)
