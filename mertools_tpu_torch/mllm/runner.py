"""MLLM training runner in PyTorch — port of ``mertools_tpu/mllm/runner.py``
(single device).

Iteration-based epochs with gradient accumulation, LinearWarmupCosineLR,
AdamW on the trainable parameters only (the LLM base and the frozen_*
subtrees have ``requires_grad=False`` and get no gradient), a JSONL
``log.txt``, and trainable-only checkpoints.

bf16 AMP (``compute_dtype="bf16"``): the frozen parameters are held in bf16;
the trainable ones stay fp32 master copies that every module casts to bf16
where it uses them, and the batch's float arrays are cast to bf16 — what the
JAX Runner's ``cast_tree`` of params and batch computes, with no ``dW`` for
the frozen base.

Checkpoints are directories: ``trainable.pt`` (``torch.save`` of
``{"params": {name: fp32 tensor}, "epoch": e}``) and the model's
``config.json``. Reading the JAX package's orbax directories is not ported.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import re
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from ..core.device import resolve_device, upload
from .affectgpt import AffectGPT, config_from_dict, is_trainable, set_trainable


def warmup_cosine_schedule(init_lr: float, min_lr: float, warmup_steps: int,
                           total_steps: int, warmup_start_lr: float = 1e-6
                           ) -> Callable[[int], float]:
    """LinearWarmupCosineLR as the JAX package composes it from optax: the
    learning rate of update ``step`` (0 for the first) is linear from
    ``warmup_start_lr`` to ``init_lr`` over ``warmup_steps``, then cosine to
    ``min_lr`` over the remaining steps."""
    w = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)
    alpha = min_lr / init_lr if init_lr else 0.0

    def lr(step: int) -> float:
        if step < warmup_steps:
            return warmup_start_lr + (init_lr - warmup_start_lr) * min(step, w) / w
        t = min(step - warmup_steps, decay) / decay
        return init_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)

    return lr


@dataclass
class RunnerConfig:
    max_epoch: int = 10
    iters_per_epoch: int = 100
    batch_size: int = 4
    accum_grad_iters: int = 1
    init_lr: float = 1e-4
    min_lr: float = 8e-5
    warmup_steps: int = 100
    weight_decay: float = 0.05
    output_dir: str = "./mllm_output"
    compute_dtype: str | None = None   # None (fp32) | "bf16"
    frozen: tuple = ()


def _place(v, device, dtype):
    # host arrays go up through pinned memory without blocking, so the host
    # can queue the step while the device finishes the previous one
    t = v.to(device) if isinstance(v, torch.Tensor) else upload(np.asarray(v), device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


class Runner:
    """Trains ``model`` (an :class:`AffectGPT` on its device) in place."""

    def __init__(self, cfg: RunnerConfig, model: AffectGPT, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (dp/tp/pp/sp) is not ported to "
                "mertools_tpu_torch yet (ROADMAP A14)")
        if cfg.compute_dtype not in (None, "bf16"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: None or 'bf16'")
        self.cfg, self.model = cfg, model
        self.device = next(model.parameters()).device
        self.dtype = torch.bfloat16 if cfg.compute_dtype == "bf16" else None
        set_trainable(model, cfg.frozen)
        if self.dtype is not None:
            for p in model.parameters():
                if not p.requires_grad:
                    p.data = p.data.to(self.dtype)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.schedule = warmup_cosine_schedule(
            cfg.init_lr, cfg.min_lr, cfg.warmup_steps,
            cfg.max_epoch * cfg.iters_per_epoch)
        # optax.adamw's defaults; decay on every trainable leaf (optax's
        # default mask); the learning rate is set before every update
        self.opt = torch.optim.AdamW(self.params, lr=self.schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)
        self.updates = 0   # optimizer updates so far (the schedule's step)
        self._micro = 0

    def place(self, batch: dict) -> dict:
        """Host arrays -> tensors on the model's device; float arrays in the
        compute dtype."""
        return {k: _place(v, self.device, self.dtype) for k, v in batch.items()}

    def train_step(self, batch: dict) -> torch.Tensor:
        """One micro-step: forward, backward, and every ``accum_grad_iters``
        micro-steps an AdamW update on the mean gradient. Returns the loss
        (a device scalar; nothing here waits for the device)."""
        self.model.train()
        loss, _ = self.model(self.place(batch))
        (loss / self.cfg.accum_grad_iters).backward()
        self._micro += 1
        if self._micro % self.cfg.accum_grad_iters == 0:
            for group in self.opt.param_groups:
                group["lr"] = self.schedule(self.updates)
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
            self.updates += 1
        return loss.detach()

    def train_epoch(self, epoch: int, batches: Iterator[dict],
                    log_every: int = 50) -> dict:
        losses = []
        for it in range(self.cfg.iters_per_epoch):
            losses.append(self.train_step(next(batches)))
            if (it + 1) % log_every == 0:
                print(f"epoch {epoch} iter {it + 1}: loss "
                      f"{torch.stack(losses[-log_every:]).float().mean().item():.4f}")
        stats = {"epoch": epoch,
                 "train_loss": torch.stack(losses).float().mean().item()}
        self._log_stats(stats)
        return stats

    def _log_stats(self, stats: dict) -> None:
        """Append JSONL stats to output_dir/log.txt."""
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        with open(os.path.join(self.cfg.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(stats) + "\n")

    @torch.no_grad()
    def evaluate(self, batches: list[dict]) -> float:
        self.model.eval()
        return float(np.mean([self.model(self.place(b))[0].item()
                              for b in batches]))

    # -- checkpoints: trainable-only, like the reference -------------------
    def trainable_state(self) -> dict:
        return {n: p.detach().float().cpu()
                for n, p in self.model.named_parameters()
                if is_trainable(n, self.cfg.frozen)}

    def save_checkpoint(self, epoch: int, is_best: bool = False) -> str:
        path = os.path.abspath(os.path.join(
            self.cfg.output_dir,
            "checkpoint_best" if is_best else f"checkpoint_{epoch}"))
        os.makedirs(path, exist_ok=True)
        torch.save({"params": self.trainable_state(), "epoch": epoch},
                   os.path.join(path, "trainable.pt"))
        _write_config(path, self.model)
        return path

    def load_checkpoint(self, path: str):
        """Restore the trainable parameters saved by :meth:`save_checkpoint`
        (the optimizer state is not saved, as in the JAX Runner); returns
        the checkpoint's epoch."""
        return overlay_trainable(self.model, path)


def _write_config(path: str, model: AffectGPT) -> None:
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(model.cfg), f, indent=1)


def overlay_trainable(model: AffectGPT, ckpt_path: str):
    """Copy a trainable-only ``checkpoint_{epoch}`` onto ``model``'s
    parameters in place (the reference's strict=False staged checkpoint
    composition); parameters absent from it keep their values. Returns the
    checkpoint's epoch."""
    state = torch.load(os.path.join(os.path.abspath(ckpt_path), "trainable.pt"),
                       map_location="cpu", weights_only=True)
    params = dict(model.named_parameters())
    unknown = sorted(set(state["params"]) - set(params))
    if unknown:
        raise KeyError(f"{ckpt_path}: parameters the model does not have: "
                       f"{unknown[:5]}")
    with torch.no_grad():
        for name, value in state["params"].items():
            params[name].copy_(value)
    return state.get("epoch")


def epoch_checkpoints(run_dir: str, test_epoch: str | None = None,
                      test_epochs: str | None = None,
                      skip_epoch: int = 1) -> list[tuple[int, str]]:
    """Reference epoch-sweep selection (inference_hybird.py:61-84):
    ``test_epoch=N`` -> that one; ``test_epochs='a-b'`` (+skip) -> the range,
    the skip anchored at epoch 0; neither -> the last available epoch."""
    found = {}
    for p in glob.glob(os.path.join(run_dir, "checkpoint_*")):
        m = re.fullmatch(r"checkpoint_(\d+)", os.path.basename(p))
        if m:
            found[int(m.group(1))] = p
    if not found:
        raise FileNotFoundError(f"no checkpoint_N dirs under {run_dir}")
    if test_epoch is not None:
        e = int(test_epoch)
        if e not in found:
            raise FileNotFoundError(
                f"checkpoint_{e} not in {run_dir}; available epochs: "
                f"{sorted(found)}")
        return [(e, found[e])]
    if test_epochs:
        a, b = (int(x) for x in test_epochs.split("-"))
        return [(e, found[e]) for e in sorted(found)
                if a <= e <= b and e % max(1, skip_epoch) == 0]
    last = max(found)
    return [(last, found[last])]


def save_model(path: str, model: AffectGPT) -> str:
    """Full model save: ``config.json`` + ``model.pt`` (the fp32 state
    dict)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _write_config(path, model)
    torch.save({k: v.detach().float().cpu() for k, v in model.state_dict().items()},
               os.path.join(path, "model.pt"))
    return path


def restore_model(path: str, device="cuda") -> AffectGPT:
    """The :class:`AffectGPT` of a :func:`save_model` directory, on
    ``device``: the card unless the caller asks for ``"cpu"``. The weights
    are fp32, so the card runs them without TF32; a host without a card
    raises rather than falling back to the CPU."""
    device = resolve_device(device, fp32=True)
    path = os.path.abspath(path)
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_dict(json.load(f))
    model = AffectGPT(cfg, device)
    model.load_state_dict(torch.load(os.path.join(path, "model.pt"),
                                     map_location=device, weights_only=True))
    return model
