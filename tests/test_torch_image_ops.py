"""The port's separable resize and fused face preprocessing against the JAX
package's ``ops/image.py`` on the same numpy inputs: the interpolation
matrices are equal, the resized and normalised pixels within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mertools_tpu.ops import image as ji
from mertools_tpu_torch.ops import image as ti

torch.set_num_threads(1)

TOL = 1e-5  # fp32 on both sides: summation order only
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("sizes", [(112, 224), (112, 256), (240, 96), (7, 7)])
def test_resize_weight_matrix_equals_jax(method, sizes):
    np.testing.assert_array_equal(ti.resize_weight_matrix(*sizes, method),
                                  ji.resize_weight_matrix(*sizes, method))


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("shape", [(56, 56, 112, 112), (60, 45, 24, 32)])
def test_resize_separable_matches_jax(method, shape):
    h, w, oh, ow = shape
    x = np.random.default_rng(0).normal(size=(2, h, w, 3)).astype(np.float32)
    ref = np.asarray(ji.resize_separable(jnp.asarray(x), oh, ow, method))
    out = ti.resize_separable(torch.from_numpy(x), oh, ow, method).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= TOL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("resize_short,scale,mean,std", [
    (0, 1.0 / 255.0, CLIP_MEAN, CLIP_STD),           # CLIP: resize to 224
    (256, 1.0, (131.1, 103.9, 91.5), (1.0, 1.0, 1.0)),  # Resize(256) + crop
], ids=["clip", "resize_short"])
def test_fused_face_preprocess_matches_jax(resize_short, scale, mean, std):
    frames = (np.random.default_rng(1).random((3, 112, 112, 3)) * 255
              ).astype(np.uint8)
    ref = np.asarray(ji.fused_face_preprocess(
        jnp.asarray(frames), 224, mean, std, scale=scale,
        resize_short=resize_short))
    out = ti.fused_face_preprocess(torch.from_numpy(frames), 224, mean, std,
                                   scale=scale, resize_short=resize_short)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= TOL * np.abs(ref).max()
