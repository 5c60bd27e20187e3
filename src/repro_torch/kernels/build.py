"""Build and load the package's CUDA kernels (nvcc -> shared library ->
ctypes).

Each `csrc/<name>.cu` compiles on its own, with a plain C interface, into
`_build/<name>-<hash>.so` beside the package (a directory `.gitignore`
lists); the hash covers the sources and the flags, so a changed kernel
rebuilds and an unchanged one is reused. `build()` starts one nvcc per
source, all at once. Nothing here runs at import time: the CPU tests
import every module, and there is no nvcc there.

Flags: `sm_90a` (Hopper), `-fmad=false` (no FMA contraction anywhere; the
CORDIC range reduction must round like the reference), IEEE division and
square root (nvcc's defaults, no fast-math).
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

import torch

from ..core.cordic import device_constants

__all__ = ["KERNEL_SOURCES", "build", "library", "CordicParams",
           "cordic_params", "op_slots", "BUILD_DIR"]

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNEL_SOURCES = ("fxp_gemm", "paged_attention", "cordic_af",
                  "cordic_softmax")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNEL_SOURCES) -> dict:
    """Compile every named source that has no current library, one nvcc
    each, all in parallel. Returns {name: (path, seconds, ptxas report)};
    raises with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = (target, 0.0, "")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       target, tmp, time.perf_counter())
    for name, (proc, target, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, target)
        out[name] = (target, time.perf_counter() - t0, log)
    return out


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use, with
    `signatures` {function: (argtypes, restype)} declared on it."""
    if name not in _LIBS:
        path = build([name])[name][0]
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return _LIBS[name]


_MAX_STAGES = 16      # CORDIC_MAX_STAGES in csrc/cordic.cuh


class CordicParams(ctypes.Structure):
    """Mirror of `struct CordicParams` in csrc/cordic.cuh."""
    _fields_ = [("inv_ln2", ctypes.c_float), ("ln2", ctypes.c_float),
                ("inv_gain", ctypes.c_float), ("hr_n", ctypes.c_int),
                ("shifts", ctypes.c_int * _MAX_STAGES),
                ("atanh", ctypes.c_float * _MAX_STAGES)]


@functools.lru_cache(maxsize=None)
def cordic_params(hr_stages: int) -> CordicParams:
    """The range-extended HR exp's constants (repeat schedule, as
    `extended_exp_float` uses) for the device functions; one read-only
    instance per stage count."""
    c = device_constants(hr_stages, repeat_iters=True)
    if len(c["shifts"]) > _MAX_STAGES:
        raise ValueError(f"at most {_MAX_STAGES} HR stages")
    p = CordicParams(inv_ln2=float(c["inv_ln2"]), ln2=float(c["ln2"]),
                     inv_gain=float(c["inv_gain"]), hr_n=len(c["shifts"]))
    for i, (s, a) in enumerate(zip(c["shifts"], c["atanh"])):
        p.shifts[i] = s
        p.atanh[i] = float(a)
    return p


_BLOCKS_PER_SM = 32   # the most blocks an SM of sm_90 holds


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def op_slots(device: torch.device) -> torch.Tensor:
    """The CORDIC ops' workspace of per-block maxima (`csrc/fxp_snap.cuh`):
    two words for every block the card can hold, uninitialised, from the
    caching allocator (so a CUDA graph captures it in its pool)."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    return torch.empty(2 * _BLOCKS_PER_SM * _sms(index), dtype=torch.int32,
                       device=device)
