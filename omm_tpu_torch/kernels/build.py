"""Builds the port's hand-written kernels into shared libraries, loaded
with ctypes.

The CUDA library is compiled by nvcc for Hopper (`sm_90a`); the host
library compiles the same per-slot math (`csrc/exact_math.cuh`) with g++
for the CPU tests.  Both are built at first use into `build/omm_tpu_torch/`
beside the package, named by a hash of the `csrc/` sources and the
flags, and put in place by an atomic rename, so concurrent processes
share one build.  fp32 results must be bit-exact, so neither compiler
may contract `a*b + c` into an FMA or use approximate division or sqrt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "omm_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-x", "c++", "-O2", "-ffp-contract=off", "-std=c++17",
             "-D__host__=", "-D__device__=", "-D__forceinline__=inline",
             "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict = {}
#: per library: compiler output of the build this process ran (nvcc's
#: -Xptxas=-v register and shared-memory report) and its seconds
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: argument list shared by the CUDA launcher and the host driver
_EXACT_ARGS = [_P, _I, _I, _P, _P, _I, _P, _P,        # plane .. ccw
               _I, _I, _I, _I, _I, _I, _I, _I, _I,   # subdiv .. W
               _F, _F, _F, _P, _P]                   # rcp, cutoff, outs


def _digest(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".cpp"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(name: str, cmd: list, source: Path, flags: list) -> Path:
    out = BUILD_DIR / f"lib{name}_{_digest([cmd[0], *flags])}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run([*cmd, *flags, str(source), "-o", str(tmp)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {source.name} failed:\n"
                           f"{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "log": r.stdout + r.stderr}
    return out


def _nvcc() -> str:
    """nvcc on PATH, else the CUDA toolkit's default install location."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _load(name: str, cmd, source: Path, flags: list, fns: dict):
    """The loaded library `name`, built on first use; fns maps each
    exported function to its (argtypes, restype)."""
    lib = _LIBS.get(name)  # the per-launch path: one dict lookup
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name, cmd(), source, flags)))
            for fn, (argtypes, restype) in fns.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib


def cuda_library():
    """The CUDA exact-classification library (built with nvcc on first
    use).  Its `omm_exact_classify` launches on the given stream and
    returns cudaGetLastError(); `omm_exact_error_string` names it."""
    return _load("omm_exact_cuda", lambda: [_nvcc()],
                 CSRC / "exact_classify.cu", NVCC_FLAGS,
                 {"omm_exact_classify": (_EXACT_ARGS + [_P], _I),
                  "omm_exact_error_string": ([_I], ctypes.c_char_p)})


def host_library():
    """The host build of the exact stage's per-slot math (g++), whose
    `omm_exact_host` loops over blocks and slots as the kernel does."""
    return _load("omm_exact_host", lambda: ["g++"], CSRC / "exact_host.cpp",
                 GXX_FLAGS, {"omm_exact_host": (_EXACT_ARGS, _I)})
