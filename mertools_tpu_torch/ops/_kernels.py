"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and linked into ONE shared library with a plain
C interface, loaded with ``ctypes``. The build happens at first use, into
``build/kernels/`` at the root of the checkout; the file name carries a hash
of the sources and flags, so a fresh checkout builds once and later
processes reuse the library. Nothing is compiled or loaded when this module
is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from mertools_tpu_torch/csrc at first use")


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{log}")
    return "".join(logs)


def build() -> tuple[Path, float, str]:
    """Compile the sources if no library with their hash exists: one nvcc
    per ``.cu`` file, all started together, then one link.

    Returns (library path, build seconds, compiler output). The output (with
    ``ptxas -v``'s registers and spills) is kept beside the library as
    ``<name>.log``; an existing library is reused, in 0.0 s, with that log,
    and one without its log is built again."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libmertools_kernels_{h.hexdigest()[:16]}.so"
    kept = out.with_suffix(".log")
    if out.exists() and kept.exists():
        return out, 0.0, kept.read_text()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = {s: BUILD_DIR / f"{s.stem}.{tag}.o"
            for s in _sources() if s.suffix == ".cu"}
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    log = _run([[_nvcc(), *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                for s, o in objs.items()])
    log += _run([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                  *(str(o) for o in objs.values())]])
    for o in objs.values():
        o.unlink()
    tmp_log = kept.with_name(f"{kept.name}.{os.getpid()}.tmp")
    tmp_log.write_text(log)
    os.replace(tmp_log, kept)  # before the library, so a reused one has its log
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out, time.perf_counter() - t0, log


# ctypes argument types of every exported C entry point; pointers and the
# stream are c_void_p (a plain int would be cut to 32 bits), sizes c_int
SIGNATURES = {
    "mt_flash_attention_fwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 18
                               + [ctypes.c_void_p]),
    "mt_mel_power_fwd": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p]),
    "mt_mel_power_fwd_plan": [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)],
    # B3: tensors, sizes, dtype flag and device, a host int array of
    # (b, t, h) strides per tensor, the stream
    "mt_flash_attention_causal_fwd": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]),
    "mt_flash_attention_causal_bwd_prep": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]),
    "mt_flash_attention_causal_bwd_dkv": (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]),
    "mt_flash_attention_causal_bwd_dq": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]),
}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call, with every entry
    point of :data:`SIGNATURES` declared; a missing one raises by name."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if not hasattr(lib, name):
            raise RuntimeError(f"{path.name} exports no {name}")
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
