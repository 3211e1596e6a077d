"""Training losses (port of ``mertools_tpu/ops/losses.py``).

Reference semantics (``MERBench/toolkit/utils/loss.py``): ``CELoss`` is the
mean cross entropy over the batch (loss.py:5-15), ``MSELoss`` the mean
squared error (loss.py:18-28). Both take an optional ``mask`` because the
trainer pads every batch to one shape: masked rows count for nothing and
the divisor is the number of valid rows, which is the reference's loss on
unpadded data. Both compute in fp32.
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over valid rows. logits: (B, C); labels: (B,) int."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def mse(preds: torch.Tensor, targets: torch.Tensor,
        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean squared error over valid rows. preds/targets: (B,) or (B, 1)."""
    sq = (preds.reshape(-1).float() - targets.reshape(-1).float()) ** 2
    if mask is None:
        return sq.mean()
    mask = mask.reshape(-1).to(sq.dtype)
    return (sq * mask).sum() / mask.sum().clamp_min(1.0)
