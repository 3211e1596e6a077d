"""The port's trainer against the JAX package's on the CPU: one training
epoch against ``train_epoch_jit`` from the same weights and plan (dropout 0,
grad_clip 0.5, l2 1e-5), and ``run_cv`` as a whole against JAX's ``run_cv``
with each fold started from JAX's own initial weights through the
``init_model`` seam; plus the trainer's device default and its exits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.core.config import Args as JArgs
from mertools_tpu.data.dataset import FeatureDataset as JFeatureDataset
from mertools_tpu.models import get_model as j_get_model
from mertools_tpu.train import loop as j_loop
from mertools_tpu_torch.core.config import Args
from mertools_tpu_torch.data.dataset import FeatureDataset, epoch_plan
from mertools_tpu_torch.models import get_model
from mertools_tpu_torch.models.base import state_dict_from_flax
from mertools_tpu_torch.train import loop

torch.set_num_threads(1)

DIMS = (12, 10, 7)


def _raw(seed: int, n: int, feat_type: str):
    """Seeded, class-separable trimodal features: (names, emos, vals, a, t, v)."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(42)
    centers = [centers.normal(size=(6, d)) * 2.0 for d in DIMS]
    emos = rng.integers(0, 6, n)
    lens = rng.integers(2, 6, n) if feat_type != "utt" else np.ones(n, int)
    feats = [[(c[e] + 0.5 * rng.normal(size=(L, c.shape[1]))).astype(np.float32)
              for e, L in zip(emos, lens)] for c in centers]
    vals = ((emos - 3) / 6 + 0.1 * rng.normal(size=n)).astype(np.float32)
    return [f"c{i}" for i in range(n)], emos, vals, *feats


def _datasets(seed, n, feat_type):
    raw = _raw(seed, n, feat_type)
    return (FeatureDataset.from_raw(*raw, feat_type=feat_type),
            JFeatureDataset.from_raw(*raw, feat_type=feat_type))


def _args(feat_type, **kw):
    base = dict(model="attention", hidden_dim=16, dropout=0.0, lr=1e-3, l2=1e-5,
                grad_clip=-1.0, batch_size=8, epochs=3, num_folder=2,
                output_dim1=6, output_dim2=1, metric_name="emoval", feat_type=feat_type)
    base.update(kw)
    return base


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax_fold_params(jargs, sample_batch, fold_seed):
    """The JAX trainer's initial weights for a fold (train/loop.py:180-186)."""
    _, init_key = jax.random.split(jax.random.PRNGKey(fold_seed))
    return j_get_model(jargs).init({"params": init_key}, sample_batch,
                                   train=False)["params"]


@pytest.mark.parametrize("feat_type", ["utt", "frm_align"])
def test_one_epoch_matches_train_epoch_jit(feat_type):
    """Per-batch losses and the weights after one epoch (11 batches, the
    last one wrapped and masked) agree within 1e-5 relative."""
    t_ds, j_ds = _datasets(0, 84, feat_type)
    kw = _args(feat_type, grad_clip=0.5)
    idx, mask = epoch_plan(np.arange(len(t_ds)), 8, np.random.default_rng(1))
    sample = {k: v[idx[0]] for k, v in j_ds.arrays().items()}
    state = j_loop.create_state(j_get_model(JArgs(kw)), sample, jax.random.PRNGKey(0),
                                lr=kw["lr"], l2=kw["l2"], grad_clip=kw["grad_clip"])
    model = get_model(Args(kw), (t_ds.adim, t_ds.tdim, t_ds.vdim))
    model.load_state_dict(state_dict_from_flax(state.params))
    opt = loop.ClippedAdam(model.parameters(), lr=kw["lr"], l2=kw["l2"],
                              grad_clip=kw["grad_clip"])

    data = {k: jnp.asarray(v) for k, v in j_ds.arrays().items()}
    state, ref_losses, ref_emos, _ = j_loop.train_epoch_jit(
        state, data, jnp.asarray(idx), jnp.asarray(mask), jax.random.PRNGKey(5),
        True, True)
    split = loop.Split.upload(t_ds, torch.device("cpu"))
    losses, emos, _ = loop.train_epoch(model, opt, split.data, torch.from_numpy(idx),
                                       torch.from_numpy(mask), None, True, True)
    assert losses.shape == (11,) and emos.shape == (11, 8, 6)
    assert _rel(losses.numpy(), ref_losses) <= 1e-5
    assert _rel(emos.numpy(), ref_emos) <= 1e-5
    ref_w = state_dict_from_flax(state.params)
    got_w = model.state_dict()
    assert set(got_w) == set(ref_w)
    for name, w in ref_w.items():
        if w.any():
            assert _rel(got_w[name].numpy(), w.numpy()) <= 1e-5, name
        else:
            assert not got_w[name].any(), name


def test_run_cv_matches_the_jax_trainer(monkeypatch):
    """The slice as a whole: 2 folds x 3 epochs at dropout 0, each fold
    started from JAX's initial weights. Same best epochs; eval and test
    logits and valence predictions within 1e-4 of max|ref|."""
    t_tr, j_tr = _datasets(1, 40, "utt")
    t_te, j_te = _datasets(2, 12, "utt")
    kw = _args("utt")
    seed = 3
    folds = []

    def init_from_jax(args, sample_batch, generator):
        params = _jax_fold_params(JArgs(kw), sample_batch, seed * 1000 + len(folds))
        folds.append(len(folds))
        dims = tuple(sample_batch[k].shape[-1] for k in ("audios", "texts", "videos"))
        model = get_model(args, dims)
        model.load_state_dict(state_dict_from_flax(params))
        return model

    monkeypatch.setattr(loop, "init_model", init_from_jax)
    ref = j_loop.run_cv(JArgs(kw), j_tr, {"test1": j_te}, seed=seed, verbose=False)
    got = loop.run_cv(Args(kw), t_tr, {"test1": t_te}, seed=seed, verbose=False,
                      device="cpu")
    assert folds == [0, 1]
    assert got.best_epochs == ref.best_epochs
    for fg, fr in zip(got.folds, ref.folds, strict=True):
        for split in ("eval", "test1"):
            np.testing.assert_array_equal(fg[f"{split}_indices"], fr[f"{split}_indices"])
            for key in ("emoprobs", "valpreds"):
                assert _rel(fg[f"{split}_{key}"], fr[f"{split}_{key}"]) <= 1e-4
    for k, v in ref.cv.items():
        assert abs(got.cv[k] - v) <= 1e-4
    assert _rel(got.test_results["test1"]["emoprobs"],
                ref.test_results["test1"]["emoprobs"]) <= 1e-4
    assert got.cv_str.split("_")[:2] == ref.cv_str.split("_")[:2]


def test_run_cv_defaults_to_the_card_and_names_what_waits(tmp_path):
    """No fallback to the CPU; ``savemodel`` on a fusion model (no
    backbone) trains and writes nothing, as the JAX trainer's guarded
    branch does."""
    t_tr, _ = _datasets(1, 12, "utt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.run_cv(Args(_args("utt")), t_tr)  # no fallback to the CPU
    res = loop.run_cv(Args(_args("utt", savemodel=True, epochs=1,
                                 save_root=str(tmp_path / "s"))),
                      t_tr, device="cpu", verbose=False)
    assert len(res.folds) == 2 and not (tmp_path / "s").exists()


def test_clipped_adam_clips_before_the_coupled_l2():
    """One step from zero moments: the clipped gradient plus l2 * p feeds
    Adam, whose first step is -lr * sign(g) (|g| >> eps)."""
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0, 0.5]))
    opt = loop.ClippedAdam([p], lr=0.1, l2=0.5, grad_clip=0.2)
    p.grad = torch.tensor([3.0, -0.1, -1.0])
    opt.step()
    # clipped: [0.2, -0.1, -0.2]; + 0.5 * p: [0.7, -1.1, 0.05] -> all move by lr
    torch.testing.assert_close(p.detach(), torch.tensor([0.9, -1.9, 0.4]))
    assert p.grad is None
    assert loop.ClippedAdam([p], lr=0.1, grad_clip=-1).clip is None
