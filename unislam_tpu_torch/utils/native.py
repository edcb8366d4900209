"""ctypes bridge to the native C++ helpers (isosurface extraction, frustum
masks, a depth rasterizer): the port's counterpart of
`unislam_tpu/native/lib.py`.

It builds its own copy of the source, `unislam_tpu_torch/csrc/marching.cpp`,
with g++ and the JAX bridge's flags into `build/native/` at the repository
root (listed in .gitignore), as `libunislam_native-<hash>.so`, the hash
covering the source and the flags: an edited source is rebuilt, and the
JAX package's `native/libunislam_native.so` is never touched. Each build
writes a file of its own and renames it into place, so processes that
build at once (test workers) never load a half-written library. A failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "marching.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libunislam_native-{digest}.so"


def _build() -> str:
    out = library_path()
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}."
                        f"{threading.get_ident()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError("g++ not found: it is needed to build the "
                           "marching-tetrahedra library") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {_SRC.name} failed "
                           f"(g++ exited {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build())
            lib.mt_run.restype = ctypes.c_int
            lib.mt_run.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.mt_free.restype = None
            lib.mt_free.argtypes = [ctypes.c_void_p]
            lib.frustum_mask.restype = None
            lib.frustum_mask.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_float,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.rasterize_depth.restype = None
            lib.rasterize_depth.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
            ]
            _LIB = lib
    return _LIB


def marching_tetrahedra(grid: np.ndarray,
                        level: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the `level` isosurface of grid (nx, ny, nz) float32.

    Returns (verts (V, 3) float32 in grid-index coordinates, faces (F, 3)
    int64). Triangles wind so normals point toward grid values below the
    level (SDF inside)."""
    lib = get_lib()
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    nx, ny, nz = grid.shape
    out_v = ctypes.POINTER(ctypes.c_float)()
    out_f = ctypes.POINTER(ctypes.c_int64)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.mt_run(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
        float(level), ctypes.byref(out_v), ctypes.byref(nv),
        ctypes.byref(out_f), ctypes.byref(nf))
    if rc != 0:
        raise MemoryError("marching tetrahedra allocation failed")
    try:
        verts = np.ctypeslib.as_array(out_v, shape=(nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        faces = np.ctypeslib.as_array(out_f, shape=(nf.value, 3)).copy() \
            if nf.value else np.zeros((0, 3), np.int64)
    finally:
        lib.mt_free(out_v)
        lib.mt_free(out_f)
    return verts, faces


def rasterize_depth(vertices: np.ndarray, faces: np.ndarray, w2c: np.ndarray,
                    fx, fy, cx, cy, W: int, H: int) -> np.ndarray:
    """Z-buffer depth render of a mesh from one camera (0 = no hit).
    OpenGL camera convention matching the rest of the framework."""
    lib = get_lib()
    v = np.ascontiguousarray(vertices, dtype=np.float32)
    f = np.ascontiguousarray(faces, dtype=np.int64)
    w2c34 = np.ascontiguousarray(np.asarray(w2c, np.float32)[:3, :4])
    out = np.zeros((H, W), dtype=np.float32)
    lib.rasterize_depth(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(f),
        w2c34.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        float(fx), float(fy), float(cx), float(cy), W, H,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def frustum_visibility(points: np.ndarray, w2c: np.ndarray, fx, fy, cx, cy,
                       W: int, H: int, depth_img: Optional[np.ndarray] = None,
                       trunc: float = 0.0) -> np.ndarray:
    """Visibility of world points in one camera (native loop).

    The per-frame projection test of mesh culling."""
    lib = get_lib()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    w2c34 = np.ascontiguousarray(np.asarray(w2c, np.float32)[:3, :4])
    mask = np.zeros(len(pts), dtype=np.uint8)
    if depth_img is not None:
        d = np.ascontiguousarray(depth_img, dtype=np.float32)
        dptr = d.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    else:
        dptr = ctypes.POINTER(ctypes.c_float)()
    lib.frustum_mask(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts),
        w2c34.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        float(fx), float(fy), float(cx), float(cy), W, H, dptr, float(trunc),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return mask.astype(bool)
