"""The port's ``main_corrupt`` CLI against the JAX package's on the same
videos: the same SNR and blur drawn for every clip (one
``random.Random(seed)`` in the same order), the same audio, and decoded
frames within the tolerance below.

Runs in a child process, as ``test_cli_corrupt.py`` does: libav beside
jaxlib and torch in one long pytest process has produced late-suite
XLA:CPU segfaults."""

import os
import subprocess
import sys
import textwrap

import pytest

from mertools_tpu_torch.io import video as vio

pytestmark = pytest.mark.skipif(not vio.available(),
                                reason="libmervideo.so not built")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The blurred frames entering the encoder differ by at most one level (the
# blur's float32 resizes round apart; tests/test_torch_corruption.py); the
# decoded frames are held to that level, and their mean difference to half
FRAME_MEAN_TOL = 0.5
FRAME_MAX_TOL = 1


def test_corrupt_matches_jax(tmp_path):
    code = textwrap.dedent(f"""
        import os
        import re
        import sys
        sys.path.insert(0, {REPO!r})
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
        import contextlib
        import io
        import numpy as np
        from mertools_tpu.cli.main_corrupt import main as jmain
        from mertools_tpu_torch.cli.main_corrupt import main as tmain
        from mertools_tpu_torch.io import video as vio

        rng = np.random.default_rng(0)
        os.makedirs("video")
        t = np.arange(16000) / 16000.0
        for i in range(3):
            frames = rng.integers(0, 255, size=(12, 48, 64, 3), dtype=np.uint8)
            tone = (0.4 * np.sin(2 * np.pi * (200 + 100 * i) * t)).astype(np.float32)
            vio.encode_video(f"video/c{{i}}.mp4", frames, fps=20.0, audio=tone,
                             audio_sr=16000)
        flags = ["--video_root=video", "--snr_low=5", "--snr_high=15",
                 "--blur_low=2", "--blur_high=8", "--seed=3"]
        logs = {{}}
        for side, fn, extra in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                fn(flags + [f"--save_root=out_{{side}}"] + extra)
            logs[side] = re.findall(r"(c\\d.mp4): snr=(\\S+)dB blur=(\\d+)", buf.getvalue())
        assert logs["torch"] == logs["jax"] and len(logs["jax"]) == 3, logs
        assert len({{b for _, _, b in logs["jax"]}}) > 1, logs   # draws vary
        worst_mean, worst_max = 0.0, 0
        for name, _, _ in logs["jax"]:
            a = vio.decode_frames(f"out_torch/{{name}}").astype(int)
            b = vio.decode_frames(f"out_jax/{{name}}").astype(int)
            assert a.shape == b.shape and a.shape[0] == 12
            worst_mean = max(worst_mean, float(np.abs(a - b).mean()))
            worst_max = max(worst_max, int(np.abs(a - b).max()))
            wa, sa = vio.demux_audio(f"out_torch/{{name}}")
            wb, sb = vio.demux_audio(f"out_jax/{{name}}")
            assert sa == sb
            np.testing.assert_array_equal(wa, wb)
        assert worst_mean <= {FRAME_MEAN_TOL} and worst_max <= {FRAME_MAX_TOL}, (
            worst_mean, worst_max)
        print("OK", worst_mean, worst_max)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), timeout=400)
    assert res.returncode == 0, res.stderr + res.stdout
