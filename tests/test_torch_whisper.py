"""The port's Whisper model and feature extractor against the JAX package's
on tiny configs: the same Flax params carried across by
``state_dict_from_flax``, the same numpy inputs, fp32 on the CPU within
1e-4 (summation order is the only difference); HF checkpoints through
``load_hf_state_dict`` against transformers itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.encoders import whisper as jw
from mertools_tpu.features.audio import WhisperAudioExtractor as JaxExtractor
from mertools_tpu_torch.encoders import whisper as tw
from mertools_tpu_torch.features.audio import WhisperAudioExtractor

torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    """tests/test_asr_decode.py's tiny model: d 32, 2 + 2 layers, 80 mel
    frames -> 40 encoder positions."""
    cfg = jw.WhisperConfig(d_model=32, encoder_layers=2, decoder_layers=2,
                           num_heads=4, ffn_dim=64, vocab_size=73,
                           max_source_positions=40, max_target_positions=32,
                           decoder_start_token_id=70, eos_token_id=71)
    model = jw.WhisperModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(3),
                                 np.zeros((1, 80, 80), np.float32),
                                 np.zeros((1, 4), np.int32))["params"]
    tcfg = tw.WhisperConfig(**cfg.__dict__)
    port = tw.build_model(tcfg, tw.state_dict_from_flax(tcfg, params), "cpu")
    return cfg, model, params, port


def test_model_matches_jax(tiny):
    cfg, model, params, port = tiny
    rng = np.random.default_rng(0)
    mel = rng.normal(size=(2, 80, 80)).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, size=(2, 5)).astype(np.int32)

    @jax.jit
    def ref_fn(mel, ids):
        enc = model.apply({"params": params}, mel, method=model.encode)
        return (enc, model.apply({"params": params}, ids, enc, method=model.decode),
                jw.whisper_logits(model, params, mel, ids))

    enc_ref, dec_ref, logits_ref = ref_fn(jnp.asarray(mel), jnp.asarray(ids))
    with torch.no_grad():
        enc = port.encode(torch.from_numpy(mel))
        dec = port.decode(torch.from_numpy(ids).long(), enc)
        logits = tw.whisper_logits(port, torch.from_numpy(mel),
                                   torch.from_numpy(ids).long())
    for got, ref, shape in ((enc, enc_ref, (2, 40, 32)), (dec, dec_ref, (2, 5, 32)),
                            (logits, logits_ref, (2, 5, 73))):
        assert got.shape == shape
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= TOL


def test_decoder_is_causal(tiny):
    _, _, _, port = tiny
    enc = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 40, 32)).astype(np.float32))
    with torch.no_grad():
        a = port.decode(torch.tensor([[5, 7, 9]]), enc)
        b = port.decode(torch.tensor([[5, 7, 1]]), enc)
    torch.testing.assert_close(a[:, :2], b[:, :2], rtol=0, atol=1e-6)
    assert (a[:, 2] - b[:, 2]).abs().max() > 1e-4


def _hf_tiny():
    from transformers import WhisperConfig as HFCfg
    from transformers import WhisperForConditionalGeneration

    # init_std 0.2 keeps activations O(1), as tests/test_whisper_parity.py does
    cfg = HFCfg(d_model=32, encoder_layers=2, decoder_layers=2,
                encoder_attention_heads=2, decoder_attention_heads=2,
                encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=80,
                max_source_positions=40, max_target_positions=32,
                vocab_size=97, decoder_start_token_id=90, eos_token_id=91,
                bos_token_id=91, pad_token_id=92, dropout=0.0, attention_dropout=0.0,
                activation_dropout=0.0, init_std=0.2)
    torch.manual_seed(0)
    return WhisperForConditionalGeneration(cfg).eval()


@pytest.mark.parametrize("wrapper", ["WhisperModel",
                                     "WhisperForConditionalGeneration"])
def test_load_hf_state_dict_matches_transformers(wrapper):
    hf = _hf_tiny()
    sd = (hf.model if wrapper == "WhisperModel" else hf).state_dict()
    cfg = tw.WhisperConfig.from_hf(hf.config)
    port = tw.build_model(cfg, tw.load_hf_state_dict(sd), "cpu")
    rng = np.random.default_rng(2)
    mel = torch.from_numpy(rng.normal(size=(2, 80, 80)).astype(np.float32))
    ids = torch.tensor([[cfg.decoder_start_token_id, 4, 9],
                        [cfg.decoder_start_token_id, 11, 2]])
    with torch.no_grad():
        ref = hf(input_features=mel, decoder_input_ids=ids).logits
        got = tw.whisper_logits(port, mel, ids)
        h_ref = hf.model(mel, decoder_input_ids=ids).last_hidden_state
        h = port(mel, ids)
    assert (got - ref).abs().max() <= TOL
    assert (h - h_ref).abs().max() <= TOL


def test_init_params_keys_shapes_and_scales():
    cfg = tw.WhisperConfig(d_model=64, encoder_layers=1, decoder_layers=1,
                           num_heads=4, ffn_dim=256, vocab_size=4000)
    sd = tw.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.device("meta"):
        want = tw.WhisperModel(cfg).state_dict()
    assert {k: v.shape for k, v in sd.items()} == {k: v.shape for k, v in want.items()}
    assert not sd["encoder.embed_positions.weight"].any()
    assert not sd["decoder.embed_positions.weight"].any()
    assert not sd["encoder.layers.0.fc1.bias"].any()
    assert torch.equal(sd["decoder.layer_norm.weight"], torch.ones(64))
    # Flax scales: lecun-normal kernels std 1/sqrt(fan_in), embed std 1/sqrt(D)
    for key, fan_in in (("encoder.layers.0.fc2.weight", 256),
                        ("encoder.conv1.weight", 80 * 3),
                        ("decoder.embed_tokens.weight", 64)):
        assert abs(sd[key].std().item() * fan_in ** 0.5 - 1.0) < 0.05, key
    w = sd["encoder.layers.0.fc2.weight"]
    assert w.abs().max() <= 2 * 256 ** -0.5 / 0.87962566103423978 + 1e-6


# ------------------------------------------------------------ the extractor
@pytest.fixture(scope="module")
def extractor_models():
    """A full-length (3000 mel frames, 1500 positions) tiny Whisper, as
    tests/test_whisper_parity.py builds the JAX extractor's."""
    cfg = jw.WhisperConfig(d_model=32, encoder_layers=1, decoder_layers=1,
                           num_heads=4, ffn_dim=64, vocab_size=64,
                           decoder_start_token_id=60, eos_token_id=61)
    params = jax.jit(jw.WhisperModel(cfg).init)(
        jax.random.PRNGKey(0), np.zeros((1, 80, 3000), np.float32),
        np.zeros((1, 2), np.int32))["params"]
    tcfg = tw.WhisperConfig(**cfg.__dict__)
    sd = tw.state_dict_from_flax(tcfg, params)
    return cfg, params, tcfg, sd


def test_whisper_extractor_matches_jax(extractor_models):
    cfg, params, tcfg, sd = extractor_models
    rng = np.random.default_rng(4)
    wavs = {f"c{i}": (rng.normal(size=16000 * (i + 1)) * 0.1).astype(np.float32)
            for i in range(3)}
    ref = JaxExtractor(cfg, params, batch_size=2).extract(wavs, "FRA")
    ex = WhisperAudioExtractor(tcfg, sd, batch_size=2, device="cpu")
    fra = ex.extract(wavs, "FRA")
    utt = ex.extract(wavs, "UTT")
    assert fra.keys() == utt.keys() == wavs.keys()
    for n in wavs:
        assert fra[n].shape == (2, 32) and utt[n].shape == (32,)
        assert np.abs(fra[n] - ref[n]).max() <= TOL, n
        assert np.abs(utt[n] - ref[n].mean(0)).max() <= TOL, n
    assert not np.allclose(fra["c0"], fra["c2"])


def test_whisper_extractor_int16_wire(extractor_models):
    """PCM16 sources: int16 / 32768 on the device equals the f32 wire."""
    _, _, tcfg, sd = extractor_models
    rng = np.random.default_rng(5)
    wavs16 = {f"c{i}": (rng.normal(size=16000 * (i + 1)) * 3000).astype(np.int16)
              for i in range(3)}
    wavs_f = {n: w.astype(np.float32) / 32768.0 for n, w in wavs16.items()}
    ref = WhisperAudioExtractor(tcfg, sd, batch_size=2, device="cpu").extract(
        wavs_f, "UTT")
    got = WhisperAudioExtractor(tcfg, sd, batch_size=2, transfer_dtype="int16",
                                device="cpu").extract(wavs16, "UTT")
    for n in wavs16:
        assert np.abs(got[n] - ref[n]).max() <= 1e-5, n
