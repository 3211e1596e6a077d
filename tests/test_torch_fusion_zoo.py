"""The port's fusion zoo against the JAX package's on the CPU, over the JAX
zoo test's matrix (model x feat_type, ``tests/test_fusion_zoo.py``): the
same seeded batch through the Flax model and the port from the same weights
(``state_dict_from_flax``), eval-mode outputs within 1e-5 and train-mode
gradients of interloss + CE + MSE at dropout 0 within 1e-4 of max|jax|;
``attention_topn``; MulT's offset-causal mask; the Flax-style initial
distribution of the new parameter kinds; and ``run_cv`` from JAX's initial
weights for MISA (utt) and MFN (frm_align).

MISA's transformer layer has its own dropout 0.1 in both packages; the
gradient cases set it to 0 on both sides. MFM's four prior samples are the
JAX side's draws, handed to the port through ``MFM.prior_samples``. Each JAX
function is compiled once for the module."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.core.config import Args as JArgs
from mertools_tpu.data.dataset import FeatureDataset as JFeatureDataset
from mertools_tpu.models import get_model as j_get_model
from mertools_tpu.models import mfm as j_mfm
from mertools_tpu.models import misa as j_misa
from mertools_tpu.ops import losses as j_losses
from mertools_tpu.train import loop as j_loop
from mertools_tpu_torch.core.config import Args
from mertools_tpu_torch.core.flax_init import init_flax_style
from mertools_tpu_torch.data.dataset import FeatureDataset
from mertools_tpu_torch.models import get_model
from mertools_tpu_torch.models.base import state_dict_from_flax
from mertools_tpu_torch.models.mult import offset_causal_bias
from mertools_tpu_torch.ops import losses as t_losses
from mertools_tpu_torch.train import loop

torch.set_num_threads(1)

B, LA, LT, LV = 4, 9, 7, 7
DA, DT, DV = 10, 12, 8
FWD_TOL = 1e-5   # eval outputs, max |port - jax| / max |jax|
GRAD_TOL = 1e-4  # each gradient, max |port - jax| / max |jax| (floor below)
# a gradient that is 0 in exact arithmetic (a key bias under softmax) is
# rounding noise on both sides: each tensor's max |jax| counts as at least
# this share of the largest over the model
GRAD_FLOOR = 1e-3

# (model, extra args, feat types): the JAX zoo test's matrix
ZOO = [
    ("attention", {}, ["utt", "frm_align", "frm_unalign"]),
    ("lf_dnn", {}, ["utt", "frm_align"]),
    ("tfn", {"hidden_dim": 16}, ["utt", "frm_align"]),
    ("lmf", {"rank": 3}, ["utt", "frm_align"]),
    ("misa", {"sim_weight": 0.1, "diff_weight": 0.1, "recon_weight": 0.1}, ["utt", "frm_align"]),
    ("mmim", {"cpc_layers": 2, "alpha": 0.1, "beta": 0.1}, ["utt", "frm_align"]),
    ("ef_lstm", {"num_layers": 2}, ["frm_align"]),
    ("mfn", {"mem_dim": 16}, ["frm_align"]),
    ("graph_mfn", {"mem_dim": 16}, ["frm_align"]),
    ("mfm", {"mem_dim": 16, "lda_xl": 0.1, "lda_xa": 0.1, "lda_xv": 0.1, "lda_mmd": 1.0}, ["frm_align"]),
    ("mctn", {"loss_weight": 0.3}, ["frm_align"]),
    ("mult", {"num_heads": 4, "layers": 2, "conv1d_kernel_size": 3}, ["frm_align", "frm_unalign"]),
]
CASES = [(name, extra, ft) for name, extra, fts in ZOO for ft in fts]
IDS = [f"{name}-{ft}" for name, _, ft in CASES]
MMD_KEY = jax.random.PRNGKey(2)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def make_batch(seed: int, feat_type: str) -> dict:
    rng = np.random.default_rng(seed)
    la, lv = (LA, LV) if feat_type == "frm_unalign" else (LT, LT)
    shape = (lambda L, d: (B, d)) if feat_type == "utt" else (lambda L, d: (B, L, d))
    batch = {"audios": rng.normal(size=shape(la, DA)).astype(np.float32),
             "texts": rng.normal(size=shape(LT, DT)).astype(np.float32),
             "videos": rng.normal(size=shape(lv, DV)).astype(np.float32),
             "emos": rng.integers(0, 6, size=B).astype(np.int32),
             "vals": rng.normal(size=B).astype(np.float32)}
    return batch


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class _RecordPriors:
    """While active, the JAX MFM's ``_mmd_gaussian`` appends the N(0, I)
    sample it draws to ``samples`` (tracers inside a traced function, which
    returns them)."""

    def __enter__(self):
        self.samples, self.orig = [], j_mfm._mmd_gaussian

        def record(z, key):
            self.samples.append(jax.random.normal(key, z.shape, z.dtype))
            return self.orig(z, key)

        j_mfm._mmd_gaussian = record
        return self.samples

    def __exit__(self, *exc):
        j_mfm._mmd_gaussian = self.orig


def _no_transformer_dropout(model: torch.nn.Module) -> None:
    for name, m in model.named_modules():
        if name.startswith("transformer") and hasattr(m, "p"):
            m.p = 0.0


def flax_params(init, *args, seed: int = 0, **kw) -> dict:
    """A Flax parameter tree of ``init``'s structure (``jax.eval_shape``, no
    compile), filled from a seeded numpy generator: kernels N(0, 1/fan_in)
    (fan_in: all but the last axis), biases N(0, 0.01), LayerNorm scales
    1 + N(0, 0.01) — every leaf non-trivial, so the weight carrier is held
    on each."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(functools.partial(init, **kw), *args)["params"]

    def fill(path, s):
        leaf = path[-1].key
        x = rng.normal(size=s.shape).astype(np.float32)
        if leaf == "bias":
            return 0.1 * x
        if leaf == "scale":
            return 1.0 + 0.1 * x
        return x / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _case(name: str, extra_items: tuple, feat_type: str):
    """For a case at dropout 0: the batch, Flax params, the Flax model's
    eval outputs, its train-mode loss and gradients, and MFM's prior samples
    of the eval and the train call; each JAX function compiled once."""
    extra = dict(extra_items)
    batch = make_batch(sum(map(ord, name + feat_type)), feat_type)
    args = JArgs(dict(model=name, hidden_dim=16, dropout=0.0, output_dim1=6,
                      output_dim2=1, feat_type=feat_type), **extra)
    model = j_get_model(args)
    params = flax_params(model.init, {"params": jax.random.PRNGKey(0)}, batch, train=False)

    def eval_fn(p):
        with _RecordPriors() as priors:
            return model.apply({"params": p}, batch, train=False), list(priors)

    def loss_fn(p):
        rngs = {"dropout": jax.random.PRNGKey(1), "mmd": MMD_KEY}
        with _RecordPriors() as priors:
            _, e, v, il = model.apply({"params": p}, batch, train=True, rngs=rngs)
        loss = il + j_losses.cross_entropy(e, batch["emos"]) + j_losses.mse(v, batch["vals"])
        return loss, list(priors)

    outs, eval_priors = jax.jit(eval_fn)(params)
    orig = j_misa.TorchTransformerLayer
    j_misa.TorchTransformerLayer = functools.partial(orig, dropout=0.0)
    try:
        (loss, train_priors), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        j_misa.TorchTransformerLayer = orig
    as_torch = lambda xs: [torch.tensor(np.asarray(x)) for x in xs]  # noqa: E731
    return (batch, params, [np.asarray(o) for o in outs], float(loss), grads,
            (as_torch(eval_priors), as_torch(train_priors)))


def _port(name, extra, feat_type, params):
    dims = (DA, DT, DV)
    model = get_model(Args(dict(model=name, hidden_dim=16, dropout=0.0, output_dim1=6,
                                output_dim2=1, feat_type=feat_type), **extra), dims)
    model.load_state_dict(state_dict_from_flax(params))
    return model


@pytest.mark.parametrize("name,extra,feat_type", CASES, ids=IDS)
def test_eval_outputs_match_flax(name, extra, feat_type):
    batch, params, ref, _, _, priors = _case(name, tuple(extra.items()), feat_type)
    model = _port(name, extra, feat_type, params).eval()
    if name == "mfm":
        model.prior_samples = priors[0]
    with torch.no_grad():
        got = model(_torch_batch(batch))
    assert got[1].shape == (B, 6) and got[2].shape == (B, 1)
    for g, r, what in zip(got, ref, ("features", "emos_out", "vals_out", "interloss")):
        assert tuple(g.shape) == r.shape, what
        if np.abs(r).max() == 0:
            assert not g.any(), what
        else:
            assert _rel(g.numpy(), r) <= FWD_TOL, (what, _rel(g.numpy(), r))


@pytest.mark.parametrize("name,extra,feat_type", CASES, ids=IDS)
def test_train_gradients_match_flax(name, extra, feat_type):
    batch, params, _, ref_loss, grads, priors = _case(name, tuple(extra.items()), feat_type)
    model = _port(name, extra, feat_type, params).train()
    _no_transformer_dropout(model)
    if name == "mfm":
        model.prior_samples = priors[1]
    tb = _torch_batch(batch)
    _, e, v, il = model(tb, torch.Generator().manual_seed(0))
    loss = il + t_losses.cross_entropy(e, tb["emos"]) + t_losses.mse(v, tb["vals"])
    loss.backward()
    assert abs(loss.item() - ref_loss) <= FWD_TOL * abs(ref_loss)
    ref = state_dict_from_flax(grads)
    got = dict(model.named_parameters())
    assert set(got) == set(ref)
    floor = GRAD_FLOOR * max(float(r.abs().max()) for r in ref.values())
    for pname, r in ref.items():
        p = got[pname]
        if not p.requires_grad:  # an input-side LSTM bias, frozen at 0
            assert p.grad is None and not r.any(), pname
            continue
        g = torch.zeros_like(p) if p.grad is None else p.grad
        err = float((g - r).abs().max()) / max(float(r.abs().max()), floor)
        assert err <= GRAD_TOL, (pname, err)


@functools.lru_cache(maxsize=None)
def _topn_case():
    dims = (10, 12, 8, 6)
    rng = np.random.default_rng(5)
    batch = {f"feat{i}": rng.normal(size=(B, d)).astype(np.float32)
             for i, d in enumerate(dims)}
    batch.update(emos=rng.integers(0, 6, B).astype(np.int32),
                 vals=rng.normal(size=B).astype(np.float32))
    args = dict(model="attention_topn", feat_dims=list(dims), hidden_dim=16,
                dropout=0.0, output_dim1=6, output_dim2=1)
    jm = j_get_model(JArgs(args))
    params = flax_params(jm.init, {"params": jax.random.PRNGKey(0)}, batch, train=False)
    outs = jax.jit(functools.partial(jm.apply, train=False))({"params": params}, batch)

    def loss_fn(p):
        _, e, v, il = jm.apply({"params": p}, batch, train=False)
        return il + j_losses.cross_entropy(e, batch["emos"]) + j_losses.mse(v, batch["vals"])

    grads = jax.jit(jax.grad(loss_fn))(params)
    return dims, batch, args, params, outs, grads


@pytest.mark.parametrize("what", ["outputs", "gradients"])
def test_attention_topn_matches_flax(what):
    dims, batch, args, params, outs, grads = _topn_case()
    model = get_model(Args(args), dims)
    model.load_state_dict(state_dict_from_flax(params))
    tb = _torch_batch(batch)
    f, e, v, il = model.train()(tb)
    if what == "outputs":
        assert f.shape == (B, 16) and e.shape == (B, 6)
        for g, r in zip((f, e, v), outs[:3]):
            assert _rel(g.detach().numpy(), r) <= FWD_TOL
        return
    (il + t_losses.cross_entropy(e, tb["emos"]) + t_losses.mse(v, tb["vals"])).backward()
    for pname, r in state_dict_from_flax(grads).items():
        g = dict(model.named_parameters())[pname].grad
        assert _rel(g.numpy(), r.numpy()) <= GRAD_TOL, pname


def test_mult_offset_mask():
    m = offset_causal_bias(3, 5).numpy()
    # query i attends key j iff j <= i + |5-3| = i + 2
    assert (m[0, :3] == 0).all() and np.isinf(m[0, 3:]).all()
    assert (m[2, :5] == 0).all()
    m2 = offset_causal_bias(4, 4).numpy()
    assert np.isinf(m2[0, 1:]).all() and (np.diag(m2) == 0).all()
    from mertools_tpu.models.mult import offset_causal_bias as j_bias
    for tq, tk in ((3, 5), (5, 3), (4, 4)):
        np.testing.assert_array_equal(offset_causal_bias(tq, tk).numpy(),
                                      np.asarray(j_bias(tq, tk)))


def _init_std_check(got: dict, ref: dict) -> None:
    """Per parameter, the port's initial std is the JAX initializers' within
    10% where it has enough entries, recurrent blocks are orthogonal per
    gate, and zeros and ones are where Flax has them."""
    assert set(got) == set(ref)
    for pname, r in ref.items():
        g = got[pname]
        rec = "weight_hh" in pname or "weight_ih" in pname
        for gg, rr in (zip(g.chunk(4), r.chunk(4)) if rec else [(g, r)]):
            if not rr.any() or (rr == 1).all():
                assert torch.equal(gg, rr), pname
            elif rr.numel() >= 1000:
                assert abs(float(gg.std()) / float(rr.std()) - 1) <= 0.10, pname
            if "weight_hh" in pname:
                assert torch.allclose(gg @ gg.T, torch.eye(gg.shape[0]), atol=1e-5), pname


@pytest.mark.parametrize("name,feat_type,extra", [
    ("lmf", "utt", {"rank": 5}),                  # xavier_normal raw factors
    ("misa", "utt", {}),                          # LayerNorm, multi-head attention
    ("ef_lstm", "frm_align", {"num_layers": 3}),  # a multi-layer LSTM
    ("mfn", "frm_align", {}),                     # LSTM cells
])
def test_flax_style_init_has_the_jax_initializers_std(name, feat_type, extra):
    wide = (96, 80, 64)
    shape = (lambda d: (2, d)) if feat_type == "utt" else (lambda d: (2, 3, d))
    batch = {k: np.zeros(shape(d), np.float32)
             for k, d in zip(("audios", "texts", "videos"), wide)}
    args = dict(model=name, hidden_dim=64, dropout=0.0, output_dim1=6, output_dim2=1,
                feat_type=feat_type, **extra)
    params = jax.jit(functools.partial(j_get_model(JArgs(args)).init, train=False))(
        jax.random.PRNGKey(3), batch)["params"]
    model = init_flax_style(get_model(Args(args), wide), torch.Generator().manual_seed(3))
    _init_std_check(model.state_dict(), state_dict_from_flax(params))


def test_flax_style_init_of_conv_and_bidirectional_lstm():
    """MulT's Conv1d (lecun_normal over K * in) and MCTN's bidirectional
    encoder (both directions drawn as Flax's cells) against Flax's own
    ``Conv`` and ``OptimizedLSTMCell`` initial draws."""
    import flax.linen as fnn

    from mertools_tpu_torch.models.mctn import Seq2SeqEncoder

    conv = fnn.Conv(64, kernel_size=(3,), padding="VALID", use_bias=False)
    kernel = conv.init(jax.random.PRNGKey(4), jnp.zeros((1, 5, 200)))["params"]["kernel"]
    port = init_flax_style(torch.nn.Conv1d(200, 64, 3, bias=False),
                           torch.Generator().manual_seed(4))
    _init_std_check({"proj.weight": port.weight.detach()},
                    state_dict_from_flax({"proj": {"kernel": kernel}}))
    cell = fnn.OptimizedLSTMCell(64)
    cell_params = cell.init(jax.random.PRNGKey(5), cell.initialize_carry(
        jax.random.PRNGKey(0), (1, 96)), jnp.zeros((1, 96)))["params"]
    tree = {"encoder": {"fwd": {"cell": cell_params}, "bwd": {"cell": cell_params},
                        "fc": {"kernel": np.zeros((64, 64), np.float32)}}}
    ref = state_dict_from_flax(tree)
    enc = init_flax_style(Seq2SeqEncoder(96, 64, 0.0), torch.Generator().manual_seed(5))
    got = {f"encoder.{k}": v for k, v in enc.state_dict().items()}
    ref["encoder.fc.weight"] = got["encoder.fc.weight"]
    _init_std_check(got, ref)


def _cv_datasets(seed: int, n: int, feat_type: str):
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(42)
    centers = [centers.normal(size=(6, d)) * 2.0 for d in (DA, DT, DV)]
    emos = rng.integers(0, 6, n)
    lens = rng.integers(2, 6, n) if feat_type != "utt" else np.ones(n, int)
    feats = [[(c[e] + 0.5 * rng.normal(size=(L, c.shape[1]))).astype(np.float32)
              for e, L in zip(emos, lens)] for c in centers]
    vals = ((emos - 3) / 6 + 0.1 * rng.normal(size=n)).astype(np.float32)
    raw = ([f"c{i}" for i in range(n)], emos, vals, *feats)
    return (FeatureDataset.from_raw(*raw, feat_type=feat_type),
            JFeatureDataset.from_raw(*raw, feat_type=feat_type))


@pytest.mark.parametrize("name,feat_type,extra", [
    ("misa", "utt", {"sim_weight": 0.1, "diff_weight": 0.1, "recon_weight": 0.1}),
    ("mfn", "frm_align", {"mem_dim": 16}),
])
def test_run_cv_matches_the_jax_trainer(monkeypatch, name, feat_type, extra):
    """2 folds x 3 epochs at dropout 0 (MISA's transformer dropout too),
    each fold started from JAX's initial weights: same best epochs; eval and
    test logits and valence within 1e-4 of max|ref|."""
    t_tr, j_tr = _cv_datasets(1, 40, feat_type)
    t_te, j_te = _cv_datasets(2, 12, feat_type)
    kw = dict(model=name, hidden_dim=16, dropout=0.0, lr=1e-3, l2=1e-5, grad_clip=-1.0,
              batch_size=8, epochs=3, num_folder=2, output_dim1=6, output_dim2=1,
              metric_name="emoval", feat_type=feat_type, **extra)
    seed, folds = 3, []

    def init_from_jax(args, sample_batch, generator):
        _, key = jax.random.split(jax.random.PRNGKey(seed * 1000 + len(folds)))
        params = j_get_model(JArgs(kw)).init({"params": key}, sample_batch,
                                             train=False)["params"]
        folds.append(len(folds))
        model = get_model(args, tuple(sample_batch[k].shape[-1]
                                      for k in ("audios", "texts", "videos")))
        model.load_state_dict(state_dict_from_flax(params))
        _no_transformer_dropout(model)
        return model

    monkeypatch.setattr(loop, "init_model", init_from_jax)
    monkeypatch.setattr(j_misa, "TorchTransformerLayer",
                        functools.partial(j_misa.TorchTransformerLayer, dropout=0.0))
    ref = j_loop.run_cv(JArgs(kw), j_tr, {"test1": j_te}, seed=seed, verbose=False)
    got = loop.run_cv(Args(kw), t_tr, {"test1": t_te}, seed=seed, verbose=False,
                      device="cpu")
    assert folds == [0, 1]
    assert got.best_epochs == ref.best_epochs
    for fg, fr in zip(got.folds, ref.folds, strict=True):
        for split in ("eval", "test1"):
            for key in ("emoprobs", "valpreds"):
                assert _rel(fg[f"{split}_{key}"], fr[f"{split}_{key}"]) <= 1e-4
    assert _rel(got.test_results["test1"]["emoprobs"],
                ref.test_results["test1"]["emoprobs"]) <= 1e-4


def test_ef_lstm_layer_by_layer_path_is_the_stack():
    """In training with dropout, EF_LSTM runs its nn.LSTM stack one layer a
    ``torch.lstm`` call with the generator's dropout between; at a dropout
    that keeps every element it equals the one-call stack."""
    batch = _torch_batch(make_batch(7, "frm_align"))
    model = get_model(Args(model="ef_lstm", hidden_dim=16, num_layers=3, dropout=1e-9,
                           output_dim1=6, output_dim2=1, feat_type="frm_align"), (DA, DT, DV))
    init_flax_style(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = model.eval()(batch)
        got = model.train()(batch, torch.Generator().manual_seed(1))
    for g, r in zip(got[:3], ref[:3]):
        assert _rel(g.numpy(), r.numpy()) <= 1e-6
