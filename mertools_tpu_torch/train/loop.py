"""Training/evaluation epochs and the cross-validation loop (port of
``mertools_tpu/train/loop.py``).

The reference's core loop (``MERBench/main-release.py:17-87,193-253``), laid
out for a card:

  * the whole (small) feature dataset is uploaded once and stays on the
    device; every batch is gathered there from the epoch's index plan
    (``data[k][idx]``), and the plan's wrapped tail has mask 0, so it counts
    for nothing;
  * no host sync inside an epoch: per-batch losses and logits stay on the
    device, and the epoch's train, eval and test outputs come to the host
    together once it is queued, for the metrics;
  * optimizer: Adam with coupled L2 (torch ``Adam(weight_decay=l2)``) after
    elementwise gradient value-clipping (``clip_grad_value_``), the JAX
    package's optax chain in the same order;
  * best-epoch selection and per-fold test averaging follow ``metric.py``.

Logit collections keep the reference quirk of calling raw logits
"emo_probs" and averaging them across folds before argmax
(``metric.py:57-99``).

One ``seed`` gives the JAX package's folds and batch orders: ``kfold_indices``
then one ``epoch_plan`` shuffle per epoch, from one numpy generator. A fold's
model is drawn by :func:`init_model` from a CPU generator seeded with
``seed * 1000 + fold`` (so the card and the CPU start from the same
weights), and its dropout masks from a generator on the device with the same
seed.

``e2e_model`` (raw-input fine-tuning) runs through the same loop: a fold's
head is drawn as above, its backbone is the pretrained one
(``args["_e2e_backbone_params"]``, loaded over the drawn model as the JAX
trainer overlays it, ``train/loop.py:188-193``) or, without one, drawn by
the encoder's ``init_params``. One optimizer steps every parameter: the JAX
trainer never applies ``e2e_param_labels``' 1/10 backbone rate. Under
``args.savemodel`` the backbone of the last epoch whose eval metric ties
the best so far (JAX's ``>=``; the reported best epoch is the first, by
argmax) is copied to the host and written to
``{save_root}/model/fold{i}_backbone`` as ``config.json`` +
``pytorch_model.bin`` (``core.checkpoint.write_hf_checkpoint``), where the
JAX trainer writes an orbax tree.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..core.config import Args
from ..core.device import resolve_device, upload
from ..core.flax_init import init_flax_style
from ..data import cv as cv_mod
from ..data.dataset import FeatureDataset, epoch_plan
from ..models import get_model
from ..ops import losses, metrics


class ClippedAdam:
    """The JAX trainer's ``make_optimizer`` (``train/loop.py:42-51``):
    ``clip_grad_value_(grad_clip)`` (skipped at -1), then ``Adam(lr,
    weight_decay=l2, eps=1e-8)`` — optax's clip -> coupled L2 -> Adam, in
    that order. :meth:`step` also clears the gradients."""

    def __init__(self, params, lr: float, l2: float = 1e-5,
                 grad_clip: float = -1.0):
        self.params = [p for p in params if p.requires_grad]
        self.clip = None if grad_clip is None or grad_clip == -1 else float(grad_clip)
        self.adam = torch.optim.Adam(self.params, lr=lr, eps=1e-8,
                                     weight_decay=l2 or 0.0)

    def step(self) -> None:
        if self.clip is not None:
            torch.nn.utils.clip_grad_value_(self.params, self.clip)
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)


def init_model(args: Args, sample_batch: dict, generator: torch.Generator
               ) -> torch.nn.Module:
    """A fold's fresh model on the CPU: ``args.model`` at the widths of
    ``sample_batch`` (host arrays: audio, text and video, or a top-N
    dataset's ``feat0..feat{K-1}``), drawn by :func:`init_flax_style` from
    ``generator``. :func:`run_cv` builds every fold through this name, so a
    test can give the folds other starting weights.

    ``e2e_model``: the head is drawn so; the backbone is drawn by its
    encoder's ``init_params`` when there is no pretrained one, else left
    for :func:`run_cv` to load (``args["_e2e_backbone_params"]``)."""
    if args.model == "e2e_model":
        model = get_model(args, ())
        init_flax_style(model.encoder, generator)
        init_flax_style(model.heads, generator)
        if args.get("_e2e_backbone_params") is None:
            model.backbone.load_state_dict(model.init_backbone(generator))
        return model
    keys = ([f"feat{i}" for i in range(sum(k.startswith("feat") for k in sample_batch))]
            or ["audios", "texts", "videos"])
    dims = tuple(sample_batch[k].shape[-1] for k in keys)
    return init_flax_style(get_model(args, dims), generator)


@dataclass
class Split:
    """A dataset on the device, with its labels kept on the host for the
    metrics."""

    data: dict[str, torch.Tensor]
    emos: np.ndarray
    vals: np.ndarray

    @classmethod
    def upload(cls, ds: FeatureDataset, device: torch.device) -> "Split":
        return cls({k: upload(np.ascontiguousarray(v), device)
                    for k, v in ds.arrays().items()}, ds.emos, ds.vals)


def _gather(data: dict, idx: torch.Tensor) -> dict:
    return {k: v.index_select(0, idx) for k, v in data.items()}


def compute_loss(model, batch, mask, generator, use_emo: bool, use_val: bool):
    """One batch's loss (the model's interloss, masked CE and MSE) and its
    emotion and valence outputs."""
    _, emos_out, vals_out, interloss = model(batch, generator)
    loss = interloss
    if use_emo:
        loss = loss + losses.cross_entropy(emos_out, batch["emos"], mask)
    if use_val:
        loss = loss + losses.mse(vals_out, batch["vals"], mask)
    return loss, emos_out, vals_out


def _plan_on(plan: tuple[np.ndarray, np.ndarray], device: torch.device):
    return upload(plan[0], device), upload(plan[1], device)


def train_epoch(model, opt: ClippedAdam, data: dict, idx: torch.Tensor,
                mask: torch.Tensor, generator: torch.Generator | None,
                use_emo: bool, use_val: bool):
    """One epoch over the plan's batches (idx/mask: (nb, B) on the device).
    Returns the per-batch losses (nb,) and logits (nb, B, C), on the device."""
    model.train()
    out_l, out_e, out_v = [], [], []
    for b in range(idx.shape[0]):
        batch = _gather(data, idx[b])
        loss, emos_out, vals_out = compute_loss(model, batch, mask[b], generator,
                                                 use_emo, use_val)
        loss.backward()
        opt.step()
        out_l.append(loss.detach())
        out_e.append(emos_out.detach())
        out_v.append(vals_out.detach())
    return torch.stack(out_l), torch.stack(out_e), torch.stack(out_v)


@torch.no_grad()
def eval_epoch(model, data: dict, idx: torch.Tensor, mask: torch.Tensor,
               use_emo: bool, use_val: bool):
    """The plan's batches in eval mode (no dropout); outputs as
    :func:`train_epoch`'s, on the device."""
    model.eval()
    out_l, out_e, out_v = [], [], []
    for b in range(idx.shape[0]):
        loss, emos_out, vals_out = compute_loss(
            model, _gather(data, idx[b]), mask[b], None, use_emo, use_val)
        out_l.append(loss)
        out_e.append(emos_out)
        out_v.append(vals_out)
    return torch.stack(out_l), torch.stack(out_e), torch.stack(out_v)


def _collect(loss_seq, emos_seq, vals_seq, idx, mask, emos_np, vals_np,
             use_emo, use_val, calc_fn=None) -> dict:
    """Host outputs of an epoch: drop padded rows, attach labels, metrics."""
    calc_fn = calc_fn or metrics.calculate_results
    flat_mask = np.asarray(mask).reshape(-1).astype(bool)
    flat_idx = np.asarray(idx).reshape(-1)[flat_mask]
    out: dict[str, Any] = {"loss": float(np.mean(loss_seq))}
    res_kw = {}
    if use_emo:
        probs = emos_seq.reshape(-1, emos_seq.shape[-1])[flat_mask]
        res_kw.update(emo_probs=probs, emo_labels=emos_np[flat_idx])
    if use_val:
        preds = vals_seq.reshape(-1, vals_seq.shape[-1])[flat_mask]
        res_kw.update(val_preds=preds.reshape(-1), val_labels=vals_np[flat_idx])
    out.update(calc_fn(**res_kw))
    out["indices"] = flat_idx
    return out


def run_epoch(model, opt: ClippedAdam, generator: torch.Generator,
              train: Split, tr_plan, eval_plan, tests: dict[str, tuple],
              use_emo: bool, use_val: bool, calc_fn=None):
    """One epoch of a fold: train on ``tr_plan``, then evaluate
    ``eval_plan`` on the train split and each ``tests[name] = (Split,
    plan)``. Everything is queued on the device first; the outputs then come
    to the host together for the metrics. Returns the epoch's store of
    ``eval_*`` and ``{name}_*`` results."""
    dev = next(iter(train.data.values())).device
    train_epoch(model, opt, train.data, *_plan_on(tr_plan, dev), generator,
                use_emo, use_val)
    queued = {"eval": (eval_epoch(model, train.data, *_plan_on(eval_plan, dev),
                                  use_emo, use_val), eval_plan, train)}
    for name, (split, plan) in tests.items():
        queued[name] = (eval_epoch(model, split.data, *_plan_on(plan, dev),
                                   use_emo, use_val), plan, split)
    store = {}
    for name, (outs, plan, split) in queued.items():
        host = [t.cpu().numpy() for t in outs]
        res = _collect(*host, *plan, split.emos, split.vals, use_emo, use_val,
                       calc_fn)
        store.update({f"{name}_{k}": v for k, v in res.items()})
    return store


@dataclass
class CVResult:
    cv: dict
    cv_str: str
    folds: list[dict]
    test_results: dict[str, dict]
    duration: float
    best_epochs: list[int] = field(default_factory=list)


def run_cv(args: Args, train_set: FeatureDataset,
           test_sets: dict[str, FeatureDataset] | None = None,
           seed: int = 0, verbose: bool = True,
           folds: list | None = None, calc_fn=None,
           device: str | torch.device = "cuda") -> CVResult:
    """Cross-validation (reference main-release.py:193-272), on the
    card unless ``device`` says otherwise (fp32, TF32 off).

    For each fold: fresh model/optimizer, ``args.epochs`` epochs, pick the
    best epoch by ``args.metric_name`` on the eval split, keep that epoch's
    eval/test outputs; finally average test logits across folds.
    """
    dev = resolve_device(device, fp32=True)
    test_sets = test_sets or {}
    use_emo = (args.output_dim1 or 0) > 0
    use_val = (args.output_dim2 or 0) > 0
    metric_name = args.metric_name or "emoval"
    batch_size = args.batch_size or 32
    epochs = args.epochs or 100
    num_folds = args.num_folder or 5

    rng_np = np.random.default_rng(seed)
    if folds is None:
        folds = cv_mod.kfold_indices(len(train_set), num_folds, rng_np)

    arrays = train_set.arrays()
    train = Split.upload(train_set, dev)
    tests = {name: (Split.upload(ds, dev), epoch_plan(np.arange(len(ds)), batch_size))
             for name, ds in test_sets.items()}

    start = time.time()
    fold_best, best_epochs = [], []
    for fold_i, (train_idx, eval_idx) in enumerate(folds):
        fold_seed = seed * 1000 + fold_i
        sample_idx, _ = epoch_plan(train_idx[:batch_size], batch_size)
        sample_batch = {k: v[sample_idx[0]] for k, v in arrays.items()}
        model = init_model(args, sample_batch,
                           torch.Generator().manual_seed(fold_seed)).to(dev)
        backbone_sd = args.get("_e2e_backbone_params")
        if backbone_sd is not None:  # e2e: the pretrained backbone, after init
            model.backbone.load_state_dict(backbone_sd)
        save_backbone = bool(args.get("savemodel")) and hasattr(model, "backbone")
        opt = ClippedAdam(model.parameters(), lr=args.lr,
                             l2=args.l2 if args.l2 is not None else 1e-5,
                             grad_clip=args.grad_clip if args.grad_clip is not None else -1.0)
        generator = torch.Generator(device=dev).manual_seed(fold_seed)

        eval_plan = epoch_plan(eval_idx, batch_size)
        epoch_stores, epoch_metrics = [], []
        best_backbone = None  # (epoch, host copy) under --savemodel
        for epoch in range(epochs):
            tr_plan = epoch_plan(train_idx, batch_size, rng_np)
            store = run_epoch(model, opt, generator, train, tr_plan, eval_plan,
                              tests, use_emo, use_val, calc_fn)
            epoch_stores.append(store)
            epoch_metrics.append(metrics.gain_metric(
                {k.replace("eval_", ""): v for k, v in store.items()
                 if k.startswith("eval_")}, metric_name))
            if save_backbone and epoch_metrics[-1] >= max(epoch_metrics):
                best_backbone = (epoch, {k: v.detach().to("cpu", copy=True)
                                         for k, v in model.backbone.state_dict().items()})
            if verbose and (epoch + 1) % max(1, epochs // 4) == 0:
                print(f"  fold {fold_i + 1} epoch {epoch + 1}: "
                      f"{metric_name}={epoch_metrics[-1]:.4f}")

        best = int(np.argmax(epoch_metrics))
        best_epochs.append(best)
        fold_best.append(epoch_stores[best])
        if best_backbone is not None:
            from ..core.checkpoint import write_hf_checkpoint

            path = os.path.abspath(os.path.join(str(args.get("save_root") or "."),
                                                "model", f"fold{fold_i}_backbone"))
            write_hf_checkpoint(path, model.backbone.cfg.to_config_json(),
                                best_backbone[1])
            if verbose:
                print(f"  saved fine-tuned backbone (epoch {best_backbone[0] + 1}) "
                      f"-> {path}")
        if verbose:
            print(f"fold {fold_i + 1}/{num_folds}: best epoch {best + 1}, "
                  f"{metric_name}={epoch_metrics[best]:.4f}")

    duration = time.time() - start
    cv = metrics.cv_summary(fold_best)
    test_results = {}
    for name in test_sets:
        # rename keys to metric.py's {split}_emoprobs convention
        renamed = [{f"{name}_emoprobs": f.get(f"{name}_emoprobs"),
                    f"{name}_emolabels": f.get(f"{name}_emolabels"),
                    f"{name}_valpreds": f.get(f"{name}_valpreds"),
                    f"{name}_vallabels": f.get(f"{name}_vallabels")}
                   for f in fold_best]
        renamed = [{k: v for k, v in d.items() if v is not None} for d in renamed]
        avg = metrics.average_folds(renamed, name)
        test_results[name] = (calc_fn or metrics.calculate_results)(
            avg.get("emoprobs"), avg.get("emolabels"),
            avg.get("valpreds"), avg.get("vallabels"))

    return CVResult(cv=cv, cv_str=metrics.cv_summary_str(cv), folds=fold_best,
                    test_results=test_results, duration=duration,
                    best_epochs=best_epochs)
