"""BlazeFace-style anchor face detector and NMS — port of
``mertools_tpu/ops/face_detect.py``.

Detection (this module) -> 5-point alignment and crop (``ops/face_align``)
-> the (T, 112, 112, 3) stores every visual extractor reads. Whole frame
batches run through one detector forward and decode on the tensor's device;
NMS is a fixed number of argmax rounds, as the JAX package's ``lax.scan``.

The network is the JAX package's Flax module as an ``nn.Module``: the same
depthwise-separable blocks, two anchor scales on 16x16 and 8x8 grids, and
per-anchor box + 5 landmark offsets for 128x128 inputs. Its weights come
from a Flax parameter tree through :func:`from_flax`. Flax's ``"SAME"``
padding of a stride-2 5x5 convolution on an even input pads (1, 2), not
(2, 2), so those convolutions pad explicitly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

INPUT_SIZE = 128
N_LANDMARKS = 5
# Flax "SAME" for a 5x5 kernel: (left, right, top, bottom) as F.pad takes it
_SAME = {1: (2, 2, 2, 2), 2: (1, 2, 1, 2)}


def generate_anchors(input_size: int = INPUT_SIZE) -> np.ndarray:
    """(A, 4) anchors as (cx, cy, w, h) in [0,1]: 2 per cell on the 16x16
    grid + 6 per cell on the 8x8 grid (BlazeFace layout)."""
    anchors = []
    for grid, per_cell in ((input_size // 8, 2), (input_size // 16, 6)):
        step = 1.0 / grid
        for y in range(grid):
            for x in range(grid):
                for _ in range(per_cell):
                    anchors.append([(x + 0.5) * step, (y + 0.5) * step,
                                    1.0, 1.0])
    return np.asarray(anchors, np.float32)


class _Blaze(nn.Module):
    """Depthwise-separable block with residual (stride 2 downsamples)."""

    def __init__(self, cin: int, ch: int, stride: int = 1):
        super().__init__()
        self.stride, self.ch = stride, ch
        self.dw = nn.Conv2d(cin, cin, 5, stride=stride, groups=cin)
        self.pw = nn.Conv2d(cin, ch, 1)

    def forward(self, x):
        y = self.pw(self.dw(F.pad(x, _SAME[self.stride])))
        if self.stride == 2:
            x = F.max_pool2d(x, 2, 2)
        if x.shape[1] != self.ch:
            x = F.pad(x, (0, 0, 0, 0, 0, self.ch - x.shape[1]))
        return F.relu(y + x)


# (name, output width as a multiple of `width`, stride), in order
_BLOCKS = (("b0_0", 1, 1), ("b0_1", 1, 1), ("d1", 2, 2), ("b1_0", 2, 1),
           ("b1_1", 2, 1), ("d2", 3, 2), ("b2_0", 3, 1), ("b2_1", 3, 1),
           ("d3", 3, 2), ("b3_0", 3, 1), ("b3_1", 3, 1))


class BlazeFace(nn.Module):
    """(B, 128, 128, 3) [0,1] RGB -> (scores (B, A), boxes (B, A, 4+2L)).

    Box regressions are (dcx, dcy, w, h) relative offsets plus L landmark
    (dx, dy) pairs, in anchor-scaled units. Parameter names follow the
    Flax module's (``stem``, ``b0_0.dw``, ``score_s16``, ...)."""

    def __init__(self, width: int = 32):
        super().__init__()
        self.width = width
        self.stem = nn.Conv2d(3, width, 5, stride=2)
        cin = width
        for name, mult, stride in _BLOCKS:
            setattr(self, name, _Blaze(cin, width * mult, stride))
            cin = width * mult
        ndim = 4 + 2 * N_LANDMARKS
        for tag, per_cell in (("s16", 2), ("s8", 6)):
            setattr(self, f"score_{tag}", nn.Conv2d(cin, per_cell, 1))
            setattr(self, f"box_{tag}", nn.Conv2d(cin, per_cell * ndim, 1))

    def forward(self, x):
        x = F.relu(self.stem(F.pad(x.permute(0, 3, 1, 2), _SAME[2])))   # 64
        feats = {}
        for name, _, _ in _BLOCKS:
            x = getattr(self, name)(x)
            if name in ("b2_1", "b3_1"):                        # 16, 8
                feats["s16" if name == "b2_1" else "s8"] = x
        ndim = 4 + 2 * N_LANDMARKS
        scores, boxes = [], []
        for tag in ("s16", "s8"):
            feat = feats[tag]
            B = feat.shape[0]
            # channels last, so anchors run (y, x, per-cell) as in Flax
            score = getattr(self, f"score_{tag}")(feat).permute(0, 2, 3, 1)
            box = getattr(self, f"box_{tag}")(feat).permute(0, 2, 3, 1)
            scores.append(score.reshape(B, -1))
            boxes.append(box.reshape(B, -1, ndim))
        return torch.cat(scores, dim=1), torch.cat(boxes, dim=1)


def from_flax(params) -> dict:
    """A Flax ``BlazeFace`` parameter tree (nested dicts of arrays) ->
    ``BlazeFace.state_dict()`` tensors: kernels ``(kh, kw, in/groups, out)``
    become ``(out, in/groups, kh, kw)``."""
    sd = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            elif key == "kernel":
                sd[f"{prefix}weight"] = torch.from_numpy(
                    np.ascontiguousarray(np.asarray(val, np.float32)
                                         .transpose(3, 2, 0, 1)))
            elif key == "bias":
                sd[f"{prefix}bias"] = torch.from_numpy(np.asarray(val, np.float32).copy())
            else:
                raise ValueError(f"unexpected Flax parameter {prefix}{key}")

    walk(params, "")
    return sd


def decode_boxes(raw: torch.Tensor, anchors: torch.Tensor,
                 scale: float = 1.0) -> torch.Tensor:
    """(.., A, 4+2L) raw regressions -> (.., A, 4) (x0, y0, x1, y1) boxes +
    landmarks appended as absolute (x, y) pairs."""
    cx = anchors[:, 0] + raw[..., 0] * scale * anchors[:, 2]
    cy = anchors[:, 1] + raw[..., 1] * scale * anchors[:, 3]
    w = torch.exp(raw[..., 2] * scale) * anchors[:, 2] * 0.25
    h = torch.exp(raw[..., 3] * scale) * anchors[:, 3] * 0.25
    box = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    lms = []
    for k in range(N_LANDMARKS):
        lx = anchors[:, 0] + raw[..., 4 + 2 * k] * scale * anchors[:, 2]
        ly = anchors[:, 1] + raw[..., 5 + 2 * k] * scale * anchors[:, 3]
        lms.extend([lx, ly])
    return torch.cat([box, torch.stack(lms, -1)], -1)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 4) vs (..., 4) corner-format IoU."""
    x0 = torch.maximum(a[..., 0], b[..., 0])
    y0 = torch.maximum(a[..., 1], b[..., 1])
    x1 = torch.minimum(a[..., 2], b[..., 2])
    y1 = torch.minimum(a[..., 3], b[..., 3])
    inter = (x1 - x0).clamp(min=0) * (y1 - y0).clamp(min=0)
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, top_k: int = 8,
        iou_thresh: float = 0.4):
    """Static-shape greedy NMS: (A, 4), (A,) -> (top_k, 4), (top_k,) with
    suppressed slots scored -inf. ``top_k`` rounds of argmax, whose first
    index wins a tie, as ``jnp.argmax``."""
    out_boxes, out_scores = [], []
    for _ in range(top_k):
        i = torch.argmax(scores)
        best_box, best_score = boxes[i], scores[i]
        keep = iou(boxes, best_box[None]) < iou_thresh
        scores = torch.where(keep, scores, -torch.inf)
        out_boxes.append(best_box)
        out_scores.append(best_score)
    return torch.stack(out_boxes), torch.stack(out_scores)


class FaceDetector:
    """Batched detect -> best-face boxes/landmarks per frame, on ``device``
    (the card unless the caller asks for the CPU), in fp32 with TF32 off
    (the JAX module runs at HIGHEST)."""

    def __init__(self, state_dict: dict, width: int = 32,
                 score_thresh: float = 0.5, device="cuda"):
        from ..core.device import resolve_device

        self.device = resolve_device(device, fp32=True)
        self.width, self.score_thresh = width, score_thresh
        self.model = BlazeFace(width)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        self.anchors = torch.from_numpy(generate_anchors()).to(self.device)

    @torch.no_grad()
    def detect_tensor(self, frames: torch.Tensor):
        """(B, 128, 128, 3) [0,1] on the detector's device -> (best
        boxes+landmarks (B, 4+2L), their probabilities (B,)) as tensors."""
        scores, raw = self.model(frames)
        dec = decode_boxes(raw, self.anchors)
        probs = torch.sigmoid(scores)
        best = torch.argmax(probs, dim=1)
        take = dec[torch.arange(len(dec), device=dec.device), best]
        return take, probs.amax(dim=1)

    def detect(self, frames):
        """(B, 128, 128, 3) [0,1] -> (boxes+landmarks (B, 4+2L), probs (B,))
        as numpy. Boxes in [0,1] image coordinates; prob < score_thresh =>
        no face."""
        x = torch.as_tensor(np.asarray(frames, np.float32)).to(self.device)
        out, probs = self.detect_tensor(x)
        return out.cpu().numpy(), probs.cpu().numpy()


# ---------------------------------------------------------------------------
# training loss (anchor matching) — for fine-tuning
# ---------------------------------------------------------------------------


def detection_loss(scores, raw, anchors, gt_boxes, scale: float = 1.0,
                   pos_iou: float = 0.35):
    """Single-face loss: anchors matching the GT (IoU > pos_iou, plus the
    best anchor) are positive; BCE on scores + L1 on box regressions.

    gt_boxes: (B, 4) corner format in [0,1]."""
    dec_anchor = torch.stack([
        anchors[:, 0] - anchors[:, 2] * 0.125,
        anchors[:, 1] - anchors[:, 3] * 0.125,
        anchors[:, 0] + anchors[:, 2] * 0.125,
        anchors[:, 1] + anchors[:, 3] * 0.125], -1)   # anchor footprint
    ious = iou(dec_anchor[None], gt_boxes[:, None])    # (B, A)
    best = torch.argmax(ious, dim=1)
    pos = ious > pos_iou
    pos[torch.arange(pos.shape[0]), best] = True

    labels = pos.float()
    cls = optax_sigmoid_bce(scores, labels).mean()

    gcx = (gt_boxes[:, 0] + gt_boxes[:, 2]) / 2
    gcy = (gt_boxes[:, 1] + gt_boxes[:, 3]) / 2
    gw = gt_boxes[:, 2] - gt_boxes[:, 0]
    gh = gt_boxes[:, 3] - gt_boxes[:, 1]
    t_cx = (gcx[:, None] - anchors[None, :, 0]) / (scale * anchors[None, :, 2])
    t_cy = (gcy[:, None] - anchors[None, :, 1]) / (scale * anchors[None, :, 3])
    t_w = torch.log(torch.clamp(gw[:, None] / (anchors[None, :, 2] * 0.25),
                                min=1e-4)) / scale
    t_h = torch.log(torch.clamp(gh[:, None] / (anchors[None, :, 3] * 0.25),
                                min=1e-4)) / scale
    targets = torch.stack([t_cx, t_cy, t_w, t_h], -1)
    reg = (raw[..., :4] - targets).abs().sum(-1)
    reg = (reg * pos).sum() / torch.clamp(pos.sum(), min=1.0)
    return cls + reg


def optax_sigmoid_bce(logits, labels):
    logp = F.logsigmoid(logits)
    lognp = F.logsigmoid(-logits)
    return -(labels * logp + (1.0 - labels) * lognp)
