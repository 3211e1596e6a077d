"""Video IO — port of ``mertools_tpu/io/video.py``: the port's own ctypes
binding to the repository's prebuilt native ``native/libmervideo.so``
(``native/mervideo.cpp``, linked against libav), with the same search and
signatures.

Replaces the reference's ffmpeg-binary audio demux
(``functions.py:269-277``), decord frame reading
(``inference_hybird.py:14-15``) and ffmpeg re-encode/mux in the corruption
pipeline (``main-corrupt.py:84-130``) with in-process libav calls — no
subprocess per clip.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_lib = None
_checked = False


def _find_lib():
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for cand in [os.path.join(here, "native", "libmervideo.so"),
                 "libmervideo.so"]:
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_f32p = ctypes.POINTER(ctypes.c_float)
        lib.mer_video_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
        lib.mer_video_info.restype = ctypes.c_int
        lib.mer_decode_frames.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(c_u8p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.mer_decode_frames.restype = ctypes.c_int
        lib.mer_demux_audio.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(c_f32p),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
        lib.mer_demux_audio.restype = ctypes.c_int
        lib.mer_encode_video.argtypes = [
            ctypes.c_char_p, c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, c_f32p, ctypes.c_int64, ctypes.c_int]
        lib.mer_encode_video.restype = ctypes.c_int
        lib.mer_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        break
    return _lib


def available() -> bool:
    return _find_lib() is not None


def video_info(path: str) -> dict:
    lib = _find_lib()
    if lib is None:
        raise RuntimeError("libmervideo.so not built (make -C native)")
    w = ctypes.c_int()
    h = ctypes.c_int()
    fps = ctypes.c_double()
    n = ctypes.c_int64()
    has_audio = ctypes.c_int()
    rc = lib.mer_video_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(fps), ctypes.byref(n),
                            ctypes.byref(has_audio))
    if rc != 0:
        raise RuntimeError(f"mer_video_info({path}) failed: {rc}")
    return {"width": w.value, "height": h.value, "fps": fps.value,
            "n_frames": n.value, "has_audio": bool(has_audio.value)}


def decode_frames(path: str, max_frames: int = 0) -> np.ndarray:
    """-> (N, H, W, 3) RGB uint8; uniform subsample when over max_frames."""
    lib = _find_lib()
    if lib is None:
        raise RuntimeError("libmervideo.so not built (make -C native)")
    buf = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_int()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.mer_decode_frames(path.encode(), max_frames, ctypes.byref(buf),
                               ctypes.byref(n), ctypes.byref(w),
                               ctypes.byref(h))
    if rc != 0:
        raise RuntimeError(f"mer_decode_frames({path}) failed: {rc}")
    size = n.value * h.value * w.value * 3
    out = np.ctypeslib.as_array(buf, shape=(size,)).copy()
    lib.mer_free(buf)
    return out.reshape(n.value, h.value, w.value, 3)


def demux_audio(path: str) -> tuple[np.ndarray, int]:
    """-> (mono float32 at native rate, sample_rate)."""
    lib = _find_lib()
    if lib is None:
        raise RuntimeError("libmervideo.so not built (make -C native)")
    buf = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    sr = ctypes.c_int()
    rc = lib.mer_demux_audio(path.encode(), ctypes.byref(buf),
                             ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        raise RuntimeError(f"mer_demux_audio({path}) failed: {rc}")
    out = np.ctypeslib.as_array(buf, shape=(n.value,)).copy()
    lib.mer_free(buf)
    return out, sr.value


def demux_audio_16k(path: str) -> np.ndarray:
    """Video -> 16 kHz mono float32 (functions.py:269-277 equivalent)."""
    from .wav import resample

    wav, sr = demux_audio(path)
    return resample(wav, sr, 16000)


def encode_video(path: str, frames: np.ndarray, fps: float = 25.0,
                 audio: np.ndarray | None = None, audio_sr: int = 16000):
    """frames: (N, H, W, 3) RGB uint8; optional mono float32 audio."""
    lib = _find_lib()
    if lib is None:
        raise RuntimeError("libmervideo.so not built (make -C native)")
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, _ = frames.shape
    a_ptr, a_n = None, 0
    if audio is not None:
        audio = np.ascontiguousarray(audio, np.float32)
        a_ptr = audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        a_n = len(audio)
    rc = lib.mer_encode_video(
        path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, w, h, fps, a_ptr, a_n, audio_sr)
    if rc != 0:
        raise RuntimeError(f"mer_encode_video({path}) failed: {rc}")
