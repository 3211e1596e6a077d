"""The port's CLIP vision tower and Token Merging against the JAX package's
``CLIPVisionEncoder`` and ``tome_merge`` on tiny configs: the same Flax
params carried across by ``state_dict_from_flax``, the same numpy pixels,
``image_embeds`` / ``pooled`` / ``last_hidden`` within 1e-4 in fp32 on the
CPU, with and without ToMe and on the flash route; ToMe's merge order on
ties; the raw-checkpoint loader on a ``CLIPModel`` save."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.encoders import vit as jv
from mertools_tpu.encoders import vit_clip as jc
from mertools_tpu_torch.encoders import vit as tv
from mertools_tpu_torch.encoders import vit_clip as tc

torch.set_num_threads(1)

TOL = 1e-4
SMALL = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
             intermediate_size=64, image_size=32, patch_size=8)
_MODEL = {}


def _model():
    """(HF vision config, JAX config, Flax params), built once."""
    if not _MODEL:
        import transformers as tr

        hf_cfg = tr.CLIPVisionConfig(**SMALL, projection_dim=24)
        torch.manual_seed(0)
        hf = tr.CLIPVisionModelWithProjection(hf_cfg).eval()
        _MODEL["m"] = (hf_cfg, *jc.from_hf_torch(hf))
    return _MODEL["m"]


# one compile a merge count, where eager dispatch compiles each primitive
_jax_tome = jax.jit(jv.tome_merge, static_argnums=(3, 4))


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg):
    """The JAX tower's jitted forward, compiled once a config."""
    return jax.jit(lambda p, x: jc.CLIPVisionEncoder(jcfg).apply({"params": p}, x))


@pytest.mark.parametrize("tome_r,flash", [(0, False), (0, True), (3, False)],
                         ids=["full", "flash", "tome3"])
def test_encoder_matches_jax(tome_r, flash):
    hf_cfg, jcfg, params = _model()
    jcfg = dataclasses.replace(jcfg, tome_r=tome_r)
    tcfg = tc.CLIPVisionConfig.from_hf(hf_cfg.to_dict())
    assert dataclasses.asdict(tcfg) == {**dataclasses.asdict(jcfg), "tome_r": 0,
                                        "use_flash_attention": False}
    tcfg = dataclasses.replace(tcfg, tome_r=tome_r, use_flash_attention=flash)
    enc = tc.CLIPVisionEncoder(tcfg)
    enc.load_state_dict(tc.state_dict_from_flax(tcfg, params), strict=True)
    pix = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = _jax_forward(jcfg)(params, jnp.asarray(pix))   # the flash case reuses full's
    with torch.no_grad():
        out = enc.eval()(torch.from_numpy(pix))
    # 16 patches + CLS, less 3 merges a layer while (N - 1) // 2 allows
    assert out["last_hidden"].shape == (2, 17 - 3 * tome_r, 32)
    for key in ("image_embeds", "pooled", "last_hidden"):
        assert out[key].shape == ref[key].shape
        assert np.abs(out[key].numpy() - np.asarray(ref[key])).max() < TOL, key


def test_flash_with_tome_raises():
    with pytest.raises(ValueError, match="B1"):
        tc.CLIPVisionConfig(tome_r=2, use_flash_attention=True)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_tome_merge_matches_jax(ties):
    """Identical tokens score equal: the stable argsort keeps JAX's order
    among them, so the same tokens merge into the same destinations."""
    rng = np.random.default_rng(3)
    B, N, D = 2, 11, 6
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    if ties:
        x[:, 3] = x[:, 5] = x[:, 7] = x[:, 2]   # three A tokens equal a B token
        x[:, 9] = x[:, 2]
    metric = x[..., :4].copy()
    sizes = rng.integers(1, 4, size=(B, N)).astype(np.float32)
    for r in (1, 3, 5):
        jo, js = _jax_tome(jnp.asarray(x), jnp.asarray(metric), jnp.asarray(sizes), r, 1)
        to, ts = tv.tome_merge(torch.from_numpy(x), torch.from_numpy(metric),
                               torch.from_numpy(sizes), r, 1)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)


def test_load_hf_state_dict_of_a_clip_model_checkpoint():
    """A ``CLIPModel`` save: its config nests ``vision_config`` and keeps
    ``projection_dim`` at the top; the text tower, ``text_projection`` and
    ``logit_scale`` go."""
    import transformers as tr

    cfg = tr.CLIPConfig(vision_config={**SMALL}, text_config=dict(
        hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=32, vocab_size=50), projection_dim=20)
    torch.manual_seed(0)
    hf = tr.CLIPModel(cfg).eval()
    tcfg = tc.CLIPVisionConfig.from_hf(cfg.to_dict())
    assert (tcfg.projection_dim, tcfg.hidden_size, tcfg.patch_size) == (20, 32, 8)
    sd = tc.load_hf_state_dict(hf.state_dict())
    assert not any(k.startswith("text_") or "logit" in k for k in sd)
    enc = tc.CLIPVisionEncoder(tcfg)
    enc.load_state_dict(sd, strict=True)
    pix = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = hf.get_image_features(torch.from_numpy(pix).permute(0, 3, 1, 2))
        got = enc.eval()(torch.from_numpy(pix))["image_embeds"]
    assert (got - want).abs().max() < TOL


def test_init_params_load_strictly_with_clip_scales():
    """HF's CLIP initialisation (factor 1) at hidden 32, 3 layers."""
    cfg = tc.CLIPVisionConfig(**SMALL, projection_dim=24)
    sd = tc.init_params(cfg, torch.Generator().manual_seed(0))
    tc.CLIPVisionEncoder(cfg).load_state_dict(sd, strict=True)
    pre = "vision_model.encoder.layers.1."
    for key, std in ((f"{pre}self_attn.k_proj.weight", 32 ** -0.5 * 6 ** -0.5),
                     (f"{pre}mlp.fc2.weight", 32 ** -0.5 * 6 ** -0.5),
                     (f"{pre}mlp.fc1.weight", 64 ** -0.5),
                     (f"{pre}self_attn.out_proj.weight", 32 ** -0.5),
                     ("visual_projection.weight", 32 ** -0.5),
                     ("vision_model.embeddings.patch_embedding.weight", 0.02)):
        assert float(sd[key].std()) == pytest.approx(std, rel=0.2), key
    assert (sd["vision_model.post_layernorm.weight"] == 1).all()
