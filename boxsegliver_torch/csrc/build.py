"""Build the CUDA sources of csrc/ with nvcc and load them with ctypes.

Each ``<name>.cu`` has a plain C interface and compiles, in seconds, into
``lib<name>-<hash>.so`` for ``sm_90a`` (Hopper) under ``build/kernels/`` at
the repository root (listed in .gitignore).  The hash covers the source and
the flags, so an edited source is rebuilt and an unchanged one is reused.  ``-Xptxas -v`` output (registers,
shared memory, spills) is kept beside each library as ``<lib>.log``.

    from boxsegliver_torch.csrc import build
    libs = build.build_all()            # one nvcc per source, in parallel
    lib = build.load("in_relu")         # builds on first use
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent
SOURCES = ("guide_render", "in_relu", "geodesic")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C signatures of each source's exported functions, set on load
_ARGTYPES = {
    "guide_render": {
        "guide_render": [_P] * 4 + [_I] * 4 + [_F] * 2 + [_P]},
    "in_relu": {
        "in_relu_fwd": [_P] * 6 + [_I] * 3 + [_F] + [_I] * 5 + [_P],
        "in_relu_bwd": [_P] * 8 + [_I] * 8 + [_P],
        "in_relu_bwd_stats": [_P] * 7 + [_I] * 6 + [_P],
        "in_relu_bwd_apply": [_P] * 8 + [_I] * 5 + [_P],
        "in_relu_fwd_partial": [_P] * 3 + [_I] * 5 + [_P],
        "in_relu_fwd_apply": [_P] * 6 + [_I] * 4 + [_P],
        "in_relu_nhwc_fwd": [_P] * 8 + [_I] * 3 + [_F] + [_I] * 8 + [_P],
        "in_relu_nhwc_bwd": [_P] * 10 + [_I] * 11 + [_P],
        "modnorm_relu_nhwc_fwd": [_P] * 2 + [_L] * 2 + [_P] * 8 + [_I] * 3
        + [_F] + [_I] * 8 + [_P],
        "modnorm_relu_nhwc_bwd": [_P] * 12 + [_I] * 11 + [_P],
        "channel_sums_nhwc": [_P] * 3 + [_I] * 7 + [_P]},
    "geodesic": {
        "geodesic2d_raster": [_P] * 4 + [_I] * 3 + [_F] + [_I] * 4 + [_P],
        "geodesic_chain_clocks": [_P] * 3 + [_I] * 2 + [_P]},
}

_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}


def build_dir() -> Path:
    return CSRC.parents[1] / "build" / "kernels"


def nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(exe).exists():
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels build only where the CUDA toolkit is")
    return exe


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def _finish(name: str, proc, tmp: Path, out: Path, cmd, t0: float):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc {proc.returncode}):\n{' '.join(cmd)}\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, ctypes.CDLL]:
    """Compile every source that has no up-to-date library, all nvcc
    processes started together, then load them all."""
    started = {}
    t0 = time.perf_counter()
    for name in names:
        if name not in _LOADED and not _lib_path(name).exists():
            started[name] = _start(name)
    for name, job in started.items():
        _finish(name, *job, t0)
    return {name: load(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name in _LOADED:
        return _LOADED[name]
    path = _lib_path(name)
    if not path.exists():
        t0 = time.perf_counter()
        _finish(name, *_start(name), t0)
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in _ARGTYPES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LOADED[name] = lib
    return lib


def ptxas_log(name: str) -> str:
    """nvcc's -Xptxas -v report of the built library."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
