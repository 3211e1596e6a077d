"""WAV reading and resampling to 16 kHz mono — the port's copy of
``mertools_tpu/io/wav.py`` (numpy + ctypes, no framework).

It binds the repository's native ``native/libmeraudio.so`` (RIFF parse, mono
mixdown, polyphase Kaiser-sinc resampler; ``native/meraudio.cpp``) and falls
back to the stdlib ``wave`` reader and scipy's ``resample_poly`` where the
library is missing, exactly as the JAX package does.
"""

from __future__ import annotations

import ctypes
import os
import wave

import numpy as np

_LIB = None
_LIB_TRIED = False


def _find_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    here = os.path.dirname(os.path.abspath(__file__))
    candidates = [
        os.path.join(here, "..", "..", "native", "libmeraudio.so"),
        os.environ.get("MERAUDIO_LIB", ""),
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            lib = ctypes.CDLL(cand)
            lib.mer_read_wav.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
            lib.mer_read_wav.restype = ctypes.c_int
            lib.mer_resample.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64)]
            lib.mer_resample.restype = ctypes.c_int
            lib.mer_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            _LIB = lib
            break
    return _LIB


def have_native() -> bool:
    return _find_lib() is not None


def _take(lib, ptr, n) -> np.ndarray:
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.mer_free(ptr)
    return arr


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Returns (mono float32 samples, sample_rate)."""
    lib = _find_lib()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_float)()
        n = ctypes.c_int64()
        sr = ctypes.c_int()
        rc = lib.mer_read_wav(path.encode(), ctypes.byref(out),
                              ctypes.byref(n), ctypes.byref(sr))
        if rc == 0:
            return _take(lib, out, n.value), sr.value
        raise IOError(f"mer_read_wav({path}) failed with {rc}")
    with wave.open(path, "rb") as w:  # fallback: stdlib wave (PCM only)
        sr = w.getframerate()
        nch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, "u1").astype(np.float32) - 128) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if nch > 1:
        data = data.reshape(-1, nch).mean(axis=1)
    return data, sr


def resample(wav: np.ndarray, sr_in: int, sr_out: int = 16000) -> np.ndarray:
    """Polyphase resample (native library; scipy fallback)."""
    wav = np.ascontiguousarray(wav, np.float32)
    if sr_in == sr_out:
        return wav
    lib = _find_lib()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_float)()
        n = ctypes.c_int64()
        rc = lib.mer_resample(
            wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(wav),
            sr_in, sr_out, ctypes.byref(out), ctypes.byref(n))
        if rc == 0:
            return _take(lib, out, n.value)
        raise RuntimeError(f"mer_resample failed with {rc}")
    from scipy.signal import resample_poly

    g = np.gcd(sr_in, sr_out)
    return resample_poly(wav, sr_out // g, sr_in // g).astype(np.float32)


def read_wav_16k(path: str) -> np.ndarray:
    """Read and resample to the pipeline's canonical 16 kHz mono."""
    wav, sr = read_wav(path)
    return resample(wav, sr, 16000)
