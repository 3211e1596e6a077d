"""The port's fusion model against the JAX package's on the CPU: MLPEncoder,
LSTMEncoder and Attention (utt and frm_align) at eval on weights moved by
``state_dict_from_flax``, the Flax-style initial distribution, the masked
losses, dropout and the factory's exits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.models import attention as j_attention
from mertools_tpu.models import modules as j_modules
from mertools_tpu.ops import losses as j_losses
from mertools_tpu_torch.core.config import Args
from mertools_tpu_torch.core.flax_init import init_flax_style
from mertools_tpu_torch.models import get_model
from mertools_tpu_torch.models import modules as t_modules
from mertools_tpu_torch.models.attention import Attention
from mertools_tpu_torch.models.base import state_dict_from_flax
from mertools_tpu_torch.ops import losses as t_losses

torch.set_num_threads(1)

DIMS = {"audios": 12, "texts": 10, "videos": 7}
FWD_TOL = 1e-5  # max |port - jax| / max |jax|, fp32


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _batch(rng, feat_type, n=5, frames=9):
    shape = (lambda d: (n, d)) if feat_type == "utt" else (lambda d: (n, frames, d))
    return {k: rng.normal(size=shape(d)).astype(np.float32) for k, d in DIMS.items()}


@pytest.mark.parametrize("kind", ["mlp", "lstm"])
def test_encoder_forward_matches_flax(rng, kind):
    x = rng.normal(size=(4, 6, 5) if kind == "lstm" else (4, 5)).astype(np.float32)
    x[0, :3] = 0.0  # front padding
    jcls, tcls = ((j_modules.LSTMEncoder, t_modules.LSTMEncoder) if kind == "lstm"
                  else (j_modules.MLPEncoder, t_modules.MLPEncoder))
    jm = jcls(16, 0.3)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    tm = tcls(5, 16, 0.3).eval()
    tm.load_state_dict(state_dict_from_flax(params))
    out = tm(torch.from_numpy(x)).detach().numpy()
    assert out.shape == ref.shape == (4, 16)
    assert _rel(out, ref) <= FWD_TOL


@pytest.mark.parametrize("feat_type", ["utt", "frm_align"])
def test_attention_forward_matches_flax(rng, feat_type):
    batch = _batch(rng, feat_type)
    jm = j_attention.Attention(hidden_dim=16, dropout=0.3, feat_type=feat_type)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), batch)["params"]
    ref = jax.jit(jm.apply)({"params": params}, batch)
    tm = Attention(*DIMS.values(), hidden_dim=16, dropout=0.3,
                   feat_type=feat_type).eval()
    tm.load_state_dict(state_dict_from_flax(params))
    out = tm({k: torch.from_numpy(v) for k, v in batch.items()})
    for r, o, shape in zip(ref[:3], out[:3], [(5, 16), (5, 6), (5, 1)]):
        assert o.shape == shape
        assert _rel(o.detach().numpy(), r) <= FWD_TOL
    assert float(out[3]) == float(ref[3]) == 0.0


def test_state_dict_from_flax_lstm_gate_blocks():
    """Flax's per-gate kernels land in torch's i, f, g, o row blocks; the
    input-side bias is 0."""
    H, D = 3, 2
    cell = {}
    for j, g in enumerate("ifgo"):
        cell[f"i{g}"] = {"kernel": np.full((D, H), j, np.float32)}
        cell[f"h{g}"] = {"kernel": np.full((H, H), 10 + j, np.float32),
                         "bias": np.full((H,), 20 + j, np.float32)}
    sd = state_dict_from_flax({"OptimizedLSTMCell_0": cell,
                               "Dense_0": {"kernel": np.eye(H, dtype=np.float32) * 2,
                                           "bias": np.ones(H, np.float32)}})
    blocks = sd["lstm.weight_ih_l0"].reshape(4, H, D)
    assert [float(b.unique()) for b in blocks] == [0, 1, 2, 3]
    assert [float(b.unique()) for b in sd["lstm.weight_hh_l0"].reshape(4, H, H)] == [10, 11, 12, 13]
    assert sd["lstm.bias_hh_l0"].reshape(4, H)[:, 0].tolist() == [20, 21, 22, 23]
    assert not sd["lstm.bias_ih_l0"].any()
    enc = t_modules.LSTMEncoder(D, H)
    enc.load_state_dict(sd)


@pytest.mark.parametrize("feat_type", ["utt", "frm_align"])
def test_flax_style_init_has_the_jax_initializers_std(rng, feat_type):
    """Per layer, the port's initial std is the JAX initializers' within
    10% (lecun_normal kernels, orthogonal recurrent blocks per gate), and
    the biases are zero in both."""
    batch = _batch(rng, feat_type, n=2, frames=3)
    wide = {"audios": 96, "texts": 80, "videos": 64}
    batch = {k: np.zeros(v.shape[:-1] + (wide[k],), np.float32) for k, v in batch.items()}
    jm = j_attention.Attention(hidden_dim=64, feat_type=feat_type)
    ref = state_dict_from_flax(jax.jit(jm.init)(jax.random.PRNGKey(3), batch)["params"])
    tm = init_flax_style(Attention(*wide.values(), hidden_dim=64, feat_type=feat_type),
                         torch.Generator().manual_seed(3))
    got = tm.state_dict()
    assert set(got) == set(ref)
    for name, r in ref.items():
        if name.endswith("weight_hh_l0") or name.endswith("weight_ih_l0"):
            pairs = zip(got[name].chunk(4), r.chunk(4))  # one gate a block
        else:
            pairs = [(got[name], r)]
        for g, rr in pairs:
            if not rr.any():
                assert not g.any(), name
            elif rr.numel() >= 1000:  # enough entries for a sample std
                assert abs(float(g.std()) / float(rr.std()) - 1) <= 0.10, name
    if feat_type == "frm_align":  # orthogonal blocks, as Flax's
        w = got["audio_encoder.lstm.weight_hh_l0"][:64]
        assert torch.allclose(w @ w.T, torch.eye(64), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(rng, masked):
    logits = rng.normal(size=(8, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 6, size=8).astype(np.int32)
    preds = rng.normal(size=(8, 1)).astype(np.float32)
    targets = rng.normal(size=(8,)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 0], np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ce_ref = float(j_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jm))
    ce = float(t_losses.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), tm))
    mse_ref = float(j_losses.mse(jnp.asarray(preds), jnp.asarray(targets), jm))
    mse = float(t_losses.mse(torch.from_numpy(preds), torch.from_numpy(targets), tm))
    assert abs(ce - ce_ref) <= 1e-6
    assert abs(mse - mse_ref) <= 1e-6


def test_losses_of_an_all_masked_batch_are_zero():
    zero = torch.zeros(4)
    assert float(t_losses.cross_entropy(torch.randn(4, 6), torch.zeros(4, dtype=torch.int32), zero)) == 0.0
    assert float(t_losses.mse(torch.randn(4), torch.randn(4), zero)) == 0.0


def test_dropout_draws_from_its_generator():
    drop = t_modules.Dropout(0.5).train()
    x = torch.ones(4000)
    a = drop(x, torch.Generator().manual_seed(7))
    b = drop(x, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert abs(float((a == 0).float().mean()) - 0.5) < 0.05
    assert torch.equal(drop.eval()(x), x)


def test_get_model_builds_attention_and_names_a7_for_the_rest():
    """Every registered zoo model builds; videomae_pretrain exits naming
    ROADMAP A7b; e2e_model builds its raw-input model (no widths)."""
    args = Args(model="attention", hidden_dim=8, dropout=0.0, feat_type="frm_align",
                output_dim1=4, output_dim2=0, lr=1e-3)
    m = get_model(args, (5, 6, 7))
    assert isinstance(m.audio_encoder, t_modules.LSTMEncoder)
    assert m.heads.fc_out_2 is None and m.heads.fc_out_1.out_features == 4
    tfn = get_model(Args(model="tfn", hidden_dim=4), (5, 6, 7))
    assert tfn.post_fusion_layer_1.in_features == 5 ** 3
    with pytest.raises(SystemExit, match="A7b"):
        get_model(Args(model="videomae_pretrain"), (5, 6, 7))
    e2e = get_model(Args(model="e2e_model", e2e_name="tiny-text", hidden_dim=8), ())
    assert e2e.cfg.modality == "text" and e2e.heads.fc_out_1.in_features == 8
