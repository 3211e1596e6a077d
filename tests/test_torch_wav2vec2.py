"""The PyTorch port's wav2vec2-family encoder against the JAX package's
``Wav2Vec2Encoder`` on tiny configs (mirroring tests/test_encoder_parity.py):
the same Flax params carried across by ``state_dict_from_flax``, the same
numpy inputs, hidden states within 1e-4 in fp32 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.encoders import wav2vec2 as jw
from mertools_tpu_torch.encoders import wav2vec2 as tw

torch.set_num_threads(1)

TOL = 1e-4  # fp32 on both sides; differences are summation order only


def _hf_model(kind):
    import transformers as tr

    common = dict(conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
                  num_feat_extract_layers=2, num_conv_pos_embeddings=16,
                  num_conv_pos_embedding_groups=2)
    if kind == "base-style":
        cfg = tr.HubertConfig(hidden_size=32, num_hidden_layers=3,
                              num_attention_heads=2, intermediate_size=48,
                              feat_extract_norm="group",
                              do_stable_layer_norm=False, **common)
        cls = tr.HubertModel
    elif kind == "large-style":
        cfg = tr.HubertConfig(hidden_size=32, num_hidden_layers=3,
                              num_attention_heads=2, intermediate_size=48,
                              feat_extract_norm="layer",
                              do_stable_layer_norm=True, conv_bias=True,
                              **common)
        cls = tr.HubertModel
    elif kind == "wavlm":
        cfg = tr.WavLMConfig(hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=64,
                             num_buckets=32, max_bucket_distance=50,
                             do_stable_layer_norm=True,
                             feat_extract_norm="layer", conv_bias=True,
                             **common)
        cls = tr.WavLMModel
    else:  # data2vec-audio
        common.update(num_conv_pos_embeddings=3)
        cfg = tr.Data2VecAudioConfig(hidden_size=32, num_hidden_layers=2,
                                     num_attention_heads=4,
                                     intermediate_size=64,
                                     conv_pos_kernel_size=7, **common)
        cls = tr.Data2VecAudioModel
    torch.manual_seed(0)
    return cls(cfg).eval()


def _port(cfg, params):
    enc = tw.Wav2Vec2Encoder(cfg)
    enc.load_state_dict(tw.state_dict_from_flax(cfg, params), strict=True)
    return enc.eval()


@pytest.mark.parametrize("kind", ["base-style", "large-style", "wavlm",
                                  "data2vec"])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_encoder_matches_jax(kind, ragged):
    jcfg, params = jw.from_hf_torch(_hf_model(kind))
    tcfg = tw.Wav2Vec2Config(**dataclasses.asdict(jcfg))
    enc = _port(tcfg, params)

    rng = np.random.default_rng(0)
    wav = (rng.normal(size=(2, 2000)) * 0.5).astype(np.float32)
    lens = np.array([2000, 1311], np.int32) if ragged else None
    ref = jw.Wav2Vec2Encoder(jcfg).apply(
        {"params": params}, jnp.asarray(wav),
        None if lens is None else jnp.asarray(lens))
    with torch.no_grad():
        got = enc(torch.from_numpy(wav),
                  None if lens is None else torch.from_numpy(lens))
    assert len(got) == len(ref) == jcfg.num_hidden_layers + 1
    for i, (g, r) in enumerate(zip(got, ref)):
        err = np.abs(g.numpy() - np.asarray(r)).max()
        assert err < TOL, (kind, i, err)


def test_config_matches_jax():
    for name in ("base", "large"):
        assert (dataclasses.asdict(getattr(tw.Wav2Vec2Config, name)())
                == dataclasses.asdict(getattr(jw.Wav2Vec2Config, name)()))
    for kind in ("wavlm", "data2vec"):
        hf_cfg = _hf_model(kind).config
        assert (dataclasses.asdict(tw.Wav2Vec2Config.from_hf(hf_cfg))
                == dataclasses.asdict(jw.Wav2Vec2Config.from_hf(hf_cfg)))
    cfg = tw.Wav2Vec2Config.large()
    lens = np.array([160000, 64000, 0])
    assert list(cfg.feat_lengths(lens)) == list(
        jw.Wav2Vec2Config.large().feat_lengths(lens))
    assert cfg.feat_lengths(160000) == 499


def test_batched_ragged_matches_per_clip():
    """End-padded batched forward with wav_lengths equals per-clip forwards
    on the valid frames (masked channel norm + key masking), on both the
    plain and the flash attention path."""
    jcfg, params = jw.from_hf_torch(_hf_model("base-style"))
    lens = np.array([800, 519], np.int32)
    rng = np.random.default_rng(1)
    wavs = [rng.normal(size=L).astype(np.float32) for L in lens]
    batch = np.zeros((2, 800), np.float32)
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = w
    for flash in (False, True):
        cfg = tw.Wav2Vec2Config(**{**dataclasses.asdict(jcfg),
                                   "use_flash_attention": flash})
        enc = _port(cfg, params)
        with torch.no_grad():
            out_b = enc(torch.from_numpy(batch), torch.from_numpy(lens))[-1]
            frames = cfg.feat_lengths(lens)
            for i, w in enumerate(wavs):
                out_s = enc(torch.from_numpy(w[None]))[-1]
                err = (out_b[i, : frames[i]] - out_s[0]).abs().max().item()
                assert err < TOL, (flash, i, err)


@pytest.mark.parametrize("naming", ["parametrizations", "weight_g"])
def test_load_hf_state_dict_matches_transformers(naming):
    """An HF HubertModel state dict loads strictly after folding the
    weight-normed positional conv (both torch namings), and the forward
    matches transformers within 1e-4."""
    hf = _hf_model("large-style")
    sd = hf.state_dict()
    if naming == "weight_g":
        base = "encoder.pos_conv_embed.conv"
        sd[f"{base}.weight_g"] = sd.pop(f"{base}.parametrizations.weight.original0")
        sd[f"{base}.weight_v"] = sd.pop(f"{base}.parametrizations.weight.original1")
    cfg = tw.Wav2Vec2Config.from_hf(hf.config)
    enc = tw.Wav2Vec2Encoder(cfg)
    enc.load_state_dict(tw.load_hf_state_dict(sd), strict=True)
    enc.eval()

    wav = np.random.default_rng(2).normal(size=(2, 1200)).astype(np.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(wav), output_hidden_states=True).hidden_states
        got = enc(torch.from_numpy(wav))
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        err = (g - r).abs().max().item()
        assert err < TOL, (i, err)


def test_load_hf_state_dict_rejects_unknown_keys():
    hf = _hf_model("base-style")
    sd = tw.load_hf_state_dict(hf.state_dict())
    sd["encoder.adapter.weight"] = torch.zeros(1)
    enc = tw.Wav2Vec2Encoder(tw.Wav2Vec2Config.from_hf(hf.config))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        enc.load_state_dict(sd, strict=True)


def test_init_params_has_flax_scale_through_depth():
    """init_params mirrors Flax's default initialisers: every tensor has the
    JAX init's shape, the kernels its standard deviation, and a deep
    narrow model's hidden states keep the JAX-initialised model's scale
    layer after layer."""
    cfg = dataclasses.replace(tw.Wav2Vec2Config.large(), hidden_size=64,
                              num_attention_heads=4, intermediate_size=128,
                              conv_dim=(32, 32), conv_kernel=(10, 3),
                              conv_stride=(5, 2), num_conv_pos_embeddings=16,
                              num_conv_pos_embedding_groups=4)
    jcfg = jw.Wav2Vec2Config(**dataclasses.asdict(cfg))
    wav = np.random.default_rng(3).normal(size=(2, 4000)).astype(np.float32)
    jparams = jw.Wav2Vec2Encoder(jcfg).init(jax.random.PRNGKey(0),
                                            wav[:1])["params"]
    from_jax = tw.state_dict_from_flax(cfg, jparams)
    ours = tw.init_params(cfg, torch.Generator().manual_seed(0))
    again = tw.init_params(cfg, torch.Generator().manual_seed(0))
    assert ours.keys() == from_jax.keys()
    for key, t in ours.items():
        assert t.shape == from_jax[key].shape, key
        assert torch.equal(t, again[key]), key  # seeded: reproducible
        if t.dim() >= 2:
            ratio = t.std().item() / from_jax[key].std().item()
            assert 0.85 < ratio < 1.15, (key, ratio)

    with torch.no_grad():
        h_ours = _loaded(cfg, ours)(torch.from_numpy(wav))
        h_jax = _loaded(cfg, from_jax)(torch.from_numpy(wav))
    for i, (a, b) in enumerate(zip(h_ours, h_jax)):
        ratio = a.std().item() / b.std().item()
        assert 0.7 < ratio < 1.4, (i, ratio)


def _loaded(cfg, sd):
    enc = tw.Wav2Vec2Encoder(cfg)
    enc.load_state_dict(sd, strict=True)
    return enc.eval()
