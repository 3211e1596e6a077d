"""The port's fusion zoo trainer side against the JAX package's: the
Flax-style initial distribution of the zoo's parameter kinds (LMF's raw
factors, MISA's LayerNorm and attention, a multi-layer LSTM, MFN's cells)
and ``run_cv`` from JAX's initial weights for MISA (utt) and MFN
(frm_align). Helpers and tolerances are ``test_torch_fusion_zoo``'s; the
two files run on two workers."""

import functools

import jax
import numpy as np
import pytest
import torch

from mertools_tpu.core.config import Args as JArgs
from mertools_tpu.data.dataset import FeatureDataset as JFeatureDataset
from mertools_tpu.models import get_model as j_get_model
from mertools_tpu.models import misa as j_misa
from mertools_tpu.train import loop as j_loop
from mertools_tpu_torch.core.config import Args
from mertools_tpu_torch.core.flax_init import init_flax_style
from mertools_tpu_torch.data.dataset import FeatureDataset
from mertools_tpu_torch.models import get_model
from mertools_tpu_torch.models.base import state_dict_from_flax
from mertools_tpu_torch.train import loop
from test_torch_fusion_zoo import DA, DT, DV, _init_std_check, _no_transformer_dropout, _rel

torch.set_num_threads(1)


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
