"""The port's checkpoint loaders for the vision zoo against the JAX
package's converters, on tiny ``transformers`` models (``Dinov2Model`` with
and without SwiGLU, ``Data2VecVisionModel`` with its pooler,
``VideoMAEModel``, ``SiglipVisionModel`` and a full ``SiglipModel``) and a
BLIP-2-style ``eva_vit_g.pth`` state dict: the config read from the
``config.json`` dict equals the JAX one, ``load_hf_state_dict`` equals
``state_dict_from_flax`` of the JAX converter's params tensor for tensor,
``hf_state_dict`` writes the read keys back, and the loaded module matches
the ``transformers`` model. A shared relative bias table is left out, as
the JAX converter leaves it out."""

import dataclasses

import numpy as np
import pytest
import torch

from mertools_tpu.encoders import siglip as js
from mertools_tpu.encoders import vit as jv
from mertools_tpu_torch.encoders import siglip as ts
from mertools_tpu_torch.encoders import vit as tv
from test_torch_audio_zoo import close

torch.set_num_threads(1)

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4)


def _hf(family: str):
    """(transformers model, JAX converter, port config builder, pixels)."""
    import transformers as tr

    torch.manual_seed(0)
    img = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 3, 28, 28)).astype(np.float32))
    if family.startswith("dinov2"):
        m = tr.Dinov2Model(tr.Dinov2Config(**TINY, mlp_ratio=2, image_size=28, patch_size=14,
                                           use_swiglu_ffn=family.endswith("swiglu")))
        return m, jv.from_hf_dinov2, tv.dinov2_config, img
    if family == "data2vec":
        m = tr.Data2VecVisionModel(tr.Data2VecVisionConfig(
            **TINY, intermediate_size=48, image_size=32, patch_size=16,
            use_relative_position_bias=True, use_mean_pooling=True),
            add_pooling_layer=True)
        with torch.no_grad():   # draw the zero-initialised tables
            for k, v in m.named_parameters():
                if "relative_position_bias_table" in k or "lambda" in k:
                    v.normal_(0.0, 0.5)
        return m, jv.from_hf_beit, tv.beit_config, torch.nn.functional.pad(img, (2, 2, 2, 2))
    if family == "videomae":
        m = tr.VideoMAEModel(tr.VideoMAEConfig(**TINY, intermediate_size=48, image_size=32,
                                               patch_size=16, num_frames=4))
        with torch.no_grad():
            for k, v in m.named_parameters():
                if k.endswith(("q_bias", "v_bias")):
                    v.normal_(0.0, 0.5)
        vid = torch.from_numpy(np.random.default_rng(3).normal(
            size=(2, 4, 3, 32, 32)).astype(np.float32))
        return m, jv.from_hf_videomae, tv.videomae_config, vid
    vcfg = dict(**TINY, intermediate_size=48, image_size=28, patch_size=7)
    if family == "siglip_vision":
        m = tr.SiglipVisionModel(tr.SiglipVisionConfig(**vcfg))
    else:
        m = tr.SiglipModel(tr.SiglipConfig(vision_config=vcfg, text_config=dict(
            hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=24, vocab_size=40)))
    return m, js.from_hf_torch, ts.SiglipVisionConfig.from_hf, img


def _eva_state_dict(rng, H=32, inter=40, patch=14, grid=2, L=2):
    """A BLIP-2 ``eva_vit_g.pth``-style state dict (timm keys)."""
    def r(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1)
    sd = {"patch_embed.proj.weight": r(H, 3, patch, patch), "patch_embed.proj.bias": r(H),
          "cls_token": r(1, 1, H), "pos_embed": r(1, grid * grid + 1, H)}
    for i in range(L):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": 1 + r(H), f"{p}.norm1.bias": r(H),
                   f"{p}.norm2.weight": 1 + r(H), f"{p}.norm2.bias": r(H),
                   f"{p}.attn.qkv.weight": r(3 * H, H), f"{p}.attn.q_bias": r(H),
                   f"{p}.attn.v_bias": r(H), f"{p}.attn.proj.weight": r(H, H),
                   f"{p}.attn.proj.bias": r(H), f"{p}.mlp.fc1.weight": r(inter, H),
                   f"{p}.mlp.fc1.bias": r(inter), f"{p}.mlp.fc2.weight": r(H, inter),
                   f"{p}.mlp.fc2.bias": r(H)})
    return sd


def _assert_same_tensors(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k].float()), k


@pytest.mark.parametrize("family", ["dinov2", "data2vec", "videomae", "eva_clip_g"])
def test_vit_loader_equals_the_jax_converter(family):
    """The JAX converter's params through ``state_dict_from_flax`` equal
    ``load_hf_state_dict`` of the raw checkpoint; the round trip writes the
    keys read back (``mask_token`` and ``pooler.*`` are not read); the
    module matches the ``transformers`` model's last hidden state. DINOv2
    also as dinov2-giant's SwiGLU, its packed ``weights_in`` split."""
    for case in (family, "dinov2_swiglu")[: 2 if family == "dinov2" else 1]:
        _check_vit_loader(case)


def _check_vit_loader(family):
    if family == "eva_clip_g":
        sd = _eva_state_dict(np.random.default_rng(4))
        jcfg, params = jv.from_eva_clip_g_checkpoint(sd)
        cfg, got = tv.eva_clip_g_from_checkpoint(sd)
    else:
        model, convert, make_cfg, pix = _hf(family)
        model.eval()
        jcfg, params = convert(model)
        cfg = make_cfg(model.config.to_dict())
        sd = model.state_dict()
        got = tv.load_hf_state_dict(cfg, sd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_same_tensors(got, tv.state_dict_from_flax(cfg, params))
    back = tv.hf_state_dict(cfg, got)
    for k, v in back.items():
        assert torch.equal(v, sd[k].float()), k
    left = sorted(set(sd) - set(back))
    assert left == {"dinov2": ["embeddings.mask_token"], "dinov2_swiglu": ["embeddings.mask_token"],
                    "data2vec": ["pooler.layernorm.bias", "pooler.layernorm.weight"]
                    }.get(family, []), left
    if family == "eva_clip_g":
        return
    enc = tv.ViTEncoder(cfg).eval()
    enc.load_state_dict(got, strict=True)
    with torch.no_grad():
        want = model(pixel_values=pix).last_hidden_state
        out, _ = enc(pix.movedim(-3, -1))
    close(out.numpy(), want.numpy())


def test_siglip_loader_equals_the_jax_converter():
    """A ``SiglipVisionModel`` and a full ``SiglipModel`` (its text tower,
    ``logit_scale`` and ``logit_bias`` dropped): the key filter equals the
    JAX converter's params; last hidden state, post-LN output and the
    pooling head match ``transformers``."""
    for family in ("siglip_vision", "siglip_full"):
        _check_siglip_loader(family)


def _check_siglip_loader(family):
    model, convert, make_cfg, pix = _hf(family)
    model.eval()
    jcfg, params = convert(model)
    cfg = make_cfg(model.config.to_dict())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = ts.load_hf_state_dict(model.state_dict())
    assert not any(k.startswith("text_model") or "logit" in k for k in got)
    _assert_same_tensors(got, ts.state_dict_from_flax(cfg, params))
    enc = ts.SiglipVisionEncoder(cfg).eval()
    enc.load_state_dict(got, strict=True)
    tower = model
    if family == "siglip_full":   # the vision half, in a SiglipVisionModel
        import transformers as tr

        tower = tr.SiglipVisionModel(model.config.vision_config).eval()
        tower.load_state_dict(got, strict=True)
    with torch.no_grad():
        ref = tower(pixel_values=pix, output_hidden_states=True)
        out = enc(pix.movedim(1, -1))
    close(out["last_hidden"].numpy(), ref.hidden_states[-1].numpy())
    close(out["post_ln"].numpy(), ref.last_hidden_state.numpy())
    close(out["pooled"].numpy(), ref.pooler_output.numpy())


def test_a_shared_relative_bias_table_is_left_out_as_jax_does():
    """``Data2VecVisionModel(use_shared_relative_position_bias=True)``: the
    JAX ``beit_config`` reads only ``use_relative_position_bias``, so its
    tower runs without the shared table and departs from ``transformers``;
    the port copies the JAX result (ROADMAP, reference-side findings)."""
    import transformers as tr

    torch.manual_seed(1)
    model = tr.Data2VecVisionModel(tr.Data2VecVisionConfig(
        **TINY, intermediate_size=48, image_size=32, patch_size=16,
        use_shared_relative_position_bias=True)).eval()
    table = "encoder.relative_position_bias.relative_position_bias_table"
    with torch.no_grad():   # a drawn table, attention's share not scaled down
        model.get_parameter(table).normal_(0.0, 1.0)
        for k, v in model.named_parameters():
            if "lambda_1" in k:
                v.fill_(1.0)
    import jax.numpy as jnp

    jcfg, params = jv.from_hf_beit(model)
    cfg = tv.beit_config(model.config.to_dict())
    assert not jcfg.rel_pos_bias and not cfg.rel_pos_bias
    sd = tv.load_hf_state_dict(cfg, model.state_dict())
    assert not any("relative_position" in k for k in tv.hf_state_dict(cfg, sd))
    pix = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jv.ViTEncoder(jcfg).apply({"params": params}, jnp.asarray(pix)))
    enc = tv.ViTEncoder(cfg).eval()
    enc.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = enc(torch.from_numpy(pix))[0].numpy()
        hf = model(pixel_values=torch.from_numpy(pix).permute(0, 3, 1, 2)).last_hidden_state
    close(out, ref)
    assert np.abs(hf.numpy() - ref).max() > 1e-2 * np.abs(ref).max()   # JAX departs from HF
