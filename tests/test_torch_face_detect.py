"""The port's BlazeFace detector against the JAX package's
``ops/face_detect.py`` on the same numpy inputs: anchors, the network from
Flax parameters (within 1e-5 relative, and not with symmetric stride-2
padding), decode, IoU and NMS (ties included), the training loss and its
gradient, and the parameter npz read without flax."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.ops import face_detect as jd
from mertools_tpu_torch.ops import face_detect as td

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5   # fp32 on both sides (HIGHEST in JAX): summation order only


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def nets():
    """For widths 16 and 32: Flax params, inputs, the JAX outputs."""
    rng = np.random.default_rng(0)
    out = {}
    for w in (16, 32):
        x = rng.random((3, 128, 128, 3)).astype(np.float32)
        model = jd.BlazeFace(width=w)
        params = jax.jit(model.init)(jax.random.PRNGKey(w), jnp.asarray(x))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        scores, raw = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
        out[w] = (params, x, np.asarray(scores), np.asarray(raw))
    return out


def test_anchors_equal():
    np.testing.assert_array_equal(td.generate_anchors(), jd.generate_anchors())
    assert td.generate_anchors().shape == (896, 4)


@pytest.mark.parametrize("width", [16, 32])
def test_blazeface_from_flax_matches_jax(nets, width):
    params, x, scores, raw = nets[width]
    model = td.BlazeFace(width)
    model.load_state_dict(td.from_flax(params))
    with torch.no_grad():
        s, r = model(torch.from_numpy(x))
    assert s.shape == scores.shape == (3, 896)
    assert r.shape == raw.shape == (3, 896, 14)
    assert _rel(s, scores) <= TOL and _rel(r, raw) <= TOL


def test_symmetric_stride2_padding_is_caught(nets, monkeypatch):
    """Conv2d(padding=2) gives the right shapes one pixel off: the parity
    check above must see it."""
    params, x, scores, raw = nets[32]
    monkeypatch.setitem(td._SAME, 2, (2, 2, 2, 2))
    model = td.BlazeFace(32)
    model.load_state_dict(td.from_flax(params))
    with torch.no_grad():
        s, r = model(torch.from_numpy(x))
    assert s.shape == scores.shape
    assert _rel(s, scores) > 100 * TOL and _rel(r, raw) > 100 * TOL


def test_decode_and_iou_match_jax():
    rng = np.random.default_rng(1)
    raw = rng.normal(size=(2, 896, 14)).astype(np.float32) * 0.5
    anchors = jd.generate_anchors()
    ref = np.asarray(jd.decode_boxes(jnp.asarray(raw), jnp.asarray(anchors)))
    got = td.decode_boxes(torch.from_numpy(raw), torch.from_numpy(anchors))
    assert np.abs(got.numpy() - ref).max() <= TOL * np.abs(ref).max()
    a = got[0, :, :4]
    b = got[1, :, :4]
    np.testing.assert_allclose(td.iou(a, b).numpy(),
                               np.asarray(jd.iou(jnp.asarray(a.numpy()),
                                                 jnp.asarray(b.numpy()))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["ties", "random"])
def test_nms_matches_jax(case):
    if case == "ties":
        # equal top scores: the first index wins, as jnp.argmax's
        boxes = np.asarray([[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9],
                            [0.12, 0.12, 0.52, 0.52], [0.61, 0.6, 0.9, 0.92],
                            [0.0, 0.7, 0.2, 0.9]], np.float32)
        scores = np.asarray([0.8, 0.9, 0.9, 0.8, 0.3], np.float32)
    else:
        rng = np.random.default_rng(2)
        lo = rng.random((40, 2)).astype(np.float32) * 0.7
        boxes = np.concatenate([lo, lo + 0.1 + rng.random((40, 2)).astype(np.float32) * 0.3], 1)
        scores = rng.random(40).astype(np.float32)
    rb, rs = jd.nms(jnp.asarray(boxes), jnp.asarray(scores), top_k=6, iou_thresh=0.4)
    gb, gs = td.nms(torch.from_numpy(boxes), torch.from_numpy(scores), top_k=6,
                    iou_thresh=0.4)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))


def test_detection_loss_and_gradient_match_jax():
    rng = np.random.default_rng(3)
    scores = rng.normal(size=(4, 896)).astype(np.float32)
    raw = rng.normal(size=(4, 896, 14)).astype(np.float32) * 0.3
    lo = rng.random((4, 2)).astype(np.float32) * 0.5
    gt = np.concatenate([lo, lo + 0.2 + rng.random((4, 2)).astype(np.float32) * 0.3], 1)
    anchors = jd.generate_anchors()

    def loss_j(s, r):
        return jd.detection_loss(s, r, jnp.asarray(anchors), jnp.asarray(gt))

    ref, (gs_ref, gr_ref) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        jnp.asarray(scores), jnp.asarray(raw))
    s = torch.from_numpy(scores).requires_grad_()
    r = torch.from_numpy(raw).requires_grad_()
    loss = td.detection_loss(s, r, torch.from_numpy(anchors), torch.from_numpy(gt))
    loss.backward()
    assert abs(loss.item() - float(ref)) <= TOL * abs(float(ref))
    assert _rel(s.grad, gs_ref) <= TOL
    assert _rel(r.grad, gr_ref) <= TOL


def test_npz_reader_runs_without_flax(nets, tmp_path):
    """The detect-faces CLI reads the JAX package's parameter npz (a pickled
    tree of numpy arrays) in a process where flax cannot be imported, and
    its detector gives the JAX outputs' best boxes."""
    params, x, scores, raw = nets[16]
    path = tmp_path / "det.npz"
    np.savez(path, params=np.array(params, dtype=object))
    np.save(tmp_path / "x.npy", x)
    code = (
        "import sys, numpy as np\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from mertools_tpu_torch.cli.preprocess import read_detector_params\n"
        "from mertools_tpu_torch.ops.face_detect import FaceDetector, from_flax\n"
        f"p = read_detector_params({str(path)!r})\n"
        "det = FaceDetector(from_flax(p), width=16, device='cpu')\n"
        f"out, probs = det.detect(np.load({str(tmp_path / 'x.npy')!r}))\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, out=out, probs=probs)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    got = np.load(tmp_path / "out.npz")
    ref_out, ref_probs = jd.FaceDetector(params, width=16).detect(x)
    assert _rel(got["probs"], ref_probs) <= TOL
    assert _rel(got["out"], ref_out) <= TOL
