"""Build the host C++ library of csrc/ with g++ and bind it with ctypes.

``boxseg_native.cpp`` (the port's own copy of the JAX package's native
library) compiles at first use into ``libboxseg_native-<hash>.so`` under
``build/native/`` at the repository root (listed in .gitignore); the hash
covers the source and the flags, so an edited source is rebuilt.  A failed
build raises: there is no fallback.

    from boxsegliver_torch.csrc import native
    dist = native.geodesic2d(image, seeds)     # float32 [h, w], FLT_MAX unreached
    dist = native.geodesic3d(volume, seeds, spacing=(2.0, 1.0, 1.0))
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parent
SOURCE = CSRC / "boxseg_native.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
FLT_MAX = float(np.finfo(np.float32).max)

_LIB: Optional[ctypes.CDLL] = None


def build_dir() -> Path:
    return CSRC.parents[1] / "build" / "native"


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return build_dir() / f"libboxseg_native-{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless an up-to-date one exists; return its
    path.  Raises RuntimeError when g++ is missing or fails."""
    out = lib_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native geodesic scan "
                           "builds only where a C++ compiler is")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (rc "
                           f"{proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        c, cf = ctypes.c_int, ctypes.c_float
        lib.geodesic2d_raster_scan.argtypes = [f32p, u8p, f32p, c, c, cf, c]
        lib.geodesic2d_raster_scan.restype = None
        lib.geodesic3d_raster_scan.argtypes = [f32p, u8p, f32p, c, c, c,
                                               cf, cf, cf, cf, c]
        lib.geodesic3d_raster_scan.restype = None
        _LIB = lib
    return _LIB


def geodesic2d(image: np.ndarray, seeds: np.ndarray, lamb: float = 1.0,
               iterations: int = 4) -> np.ndarray:
    """Raster-scan geodesic distance from the nonzero pixels of ``seeds``
    over a [h, w] image (GeodisTK semantics: lamb = 0 spatial only, 1 the
    intensity gradient only); unreached pixels hold FLT_MAX."""
    image = np.ascontiguousarray(image, np.float32)
    seeds = np.ascontiguousarray(seeds, np.uint8)
    if image.ndim != 2 or seeds.shape != image.shape:
        raise ValueError(f"geodesic2d: image {image.shape} and seeds "
                         f"{seeds.shape} must be one [h, w] shape")
    dist = np.empty(image.shape, np.float32)
    load().geodesic2d_raster_scan(image, seeds, dist, image.shape[0],
                                  image.shape[1], float(lamb),
                                  int(iterations))
    return dist


def geodesic3d(image: np.ndarray, seeds: np.ndarray, lamb: float = 1.0,
               iterations: int = 4,
               spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
               ) -> np.ndarray:
    """geodesic2d over a [d, h, w] volume: 26-neighbour raster passes whose
    spatial steps are scaled by ``spacing`` (z, y, x), as JAX's
    ``csrc.geodesic_distance``."""
    image = np.ascontiguousarray(image, np.float32)
    seeds = np.ascontiguousarray(seeds, np.uint8)
    if image.ndim != 3 or seeds.shape != image.shape:
        raise ValueError(f"geodesic3d: image {image.shape} and seeds "
                         f"{seeds.shape} must be one [d, h, w] shape")
    dist = np.empty(image.shape, np.float32)
    load().geodesic3d_raster_scan(image, seeds, dist, *image.shape,
                                  *(float(s) for s in spacing), float(lamb),
                                  int(iterations))
    return dist
