"""Build the CUDA sources under `csrc/` into shared libraries and load them.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own
with nvcc for sm_90a into `build/torch_kernels/lib<name>-<hash>.so` at the
repository root (listed in .gitignore); the hash covers the source and the
flags, so an edited kernel is rebuilt. Libraries are loaded with ctypes.
`build()` starts one nvcc per source, all at once.

`LAUNCHES` counts kernel launches by name. A wrapper adds one exactly where
it launches its kernel, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("hash_encode", "brick_encode", "scatter_accum", "fused_mlp",
           "adam_lp", "band_dedup", "composite")

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]
# hash_encode, brick_encode: no fused multiply-add anywhere, so
# `p * scale + 0.5` and `p * (res - 1) - cell` round twice like the plain
# versions and a point on a cell face gets the same cell and weights (an
# FMA rounds once and can pick the neighbouring cell). fused_mlp, adam_lp:
# the activation derivatives and the moment updates (`m*b1 + g*(1-b1)`)
# must round each product and sum as the plain versions' separate ops do.
# composite: each product and sum rounds as the plain version's separate
# ops do (its expf is the precise one: no --use_fast_math anywhere).
# band_dedup only adds and subtracts; it takes the flag all the same.
_EXTRA_FLAGS = {name: ["-fmad=false"] for name in (
    "hash_encode", "brick_encode", "fused_mlp", "adam_lp", "band_dedup",
    "composite")}

LAUNCHES: Counter = Counter()
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels")
    return path


def _target(name: str):
    src = CSRC / f"{name}.cu"
    flags = _FLAGS + _EXTRA_FLAGS.get(name, [])
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    return src, flags, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named sources that are not built yet, in parallel.
    Returns the compiler's output per source (register/spill report).
    Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, flags, out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _, _, out = _target(name)
        if not out.exists():
            build([name])
        lib = ctypes.CDLL(str(out))
        lib.unislam_error_string.restype = ctypes.c_char_p
        lib.unislam_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError)."""
    if err != 0:
        msg = lib.unislam_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
