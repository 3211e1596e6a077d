"""The port's binding to ``native/libmervideo.so``: the round trips of
``test_native_video.py`` (encode synthetic frames and a tone, decode frames
and demux audio back), and frames and audio equal to the JAX package's
binding on one file.

The libav work runs in child processes, as in ``test_native_video.py``:
libav beside jaxlib and torch in one long pytest process has produced
late-suite XLA:CPU segfaults."""

import os
import subprocess
import sys
import textwrap

import pytest

from mertools_tpu_torch.io import video as vio

pytestmark = pytest.mark.skipif(not vio.available(),
                                reason="libmervideo.so not built")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_child(body: str, tmp_path) -> str:
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        from mertools_tpu_torch.io import video as vio

        def synthetic_clip(n=25, h=64, w=48):
            frames = np.zeros((n, h, w, 3), np.uint8)
            for i in range(n):
                frames[i, :, :, 0] = min(10 * i, 255)
                frames[i, :, : w // 2, 1] = 200
            return frames
    """) + textwrap.dedent(body)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), timeout=240)
    assert res.returncode == 0, res.stderr + res.stdout
    return res.stdout


def test_encode_decode_roundtrip(tmp_path):
    _run_child("""
        frames = synthetic_clip()
        t = np.arange(16000) / 16000.0
        tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        vio.encode_video("clip.mp4", frames, fps=25.0, audio=tone,
                         audio_sr=16000)
        info = vio.video_info("clip.mp4")
        assert info["width"] == 48 and info["height"] == 64
        assert info["has_audio"]
        assert abs(info["fps"] - 25.0) < 2.0
        out = vio.decode_frames("clip.mp4")
        assert out.shape[0] == 25 and out.shape[1:] == (64, 48, 3)
        assert out[0, :, :, 0].mean() < 60
        assert out[-1, :, :, 0].mean() > 150
        assert out[5, :, :24, 1].mean() > out[5, :, 24:, 1].mean() + 50
        print("OK")
    """, tmp_path)


def test_decode_uniform_subsample(tmp_path):
    _run_child("""
        vio.encode_video("clip.mp4", synthetic_clip(n=30), fps=30.0)
        out = vio.decode_frames("clip.mp4", max_frames=10)
        assert out.shape[0] == 10
        reds = out[:, :, :, 0].mean(axis=(1, 2))
        assert reds[-1] > reds[0] + 100
        print("OK")
    """, tmp_path)


def test_demux_audio_tone(tmp_path):
    _run_child("""
        sr = 16000
        t = np.arange(sr) / sr
        tone = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
        vio.encode_video("clip.mp4", synthetic_clip(n=25), fps=25.0,
                         audio=tone, audio_sr=sr)
        wav, got_sr = vio.demux_audio("clip.mp4")
        assert got_sr == sr and len(wav) > 0.8 * sr
        spec = np.abs(np.fft.rfft(wav[:sr]))
        peak_hz = np.argmax(spec[10:]) + 10
        assert abs(peak_hz - 440) < 15, peak_hz
        wav16 = vio.demux_audio_16k("clip.mp4")
        assert wav16.dtype == np.float32 and len(wav16) > 0
        print("OK")
    """, tmp_path)


def test_decodes_equal_the_jax_packages(tmp_path):
    _run_child("""
        from mertools_tpu.io import video as jvio
        t = np.arange(16000) / 16000.0
        tone = (0.5 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
        jvio.encode_video("clip.mp4", synthetic_clip(), fps=25.0, audio=tone,
                          audio_sr=16000)
        assert vio.video_info("clip.mp4") == jvio.video_info("clip.mp4")
        np.testing.assert_array_equal(vio.decode_frames("clip.mp4", 7),
                                      jvio.decode_frames("clip.mp4", 7))
        np.testing.assert_array_equal(vio.demux_audio_16k("clip.mp4"),
                                      jvio.demux_audio_16k("clip.mp4"))
        print("OK")
    """, tmp_path)
