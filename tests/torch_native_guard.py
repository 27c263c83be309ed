"""A finished, private build of the JAX package's native library for the
port's tests.

omm_tpu.native builds libomm_native.so on first use in each process, by
`g++ ... -o libomm_native.so.tmp` and a rename, through one temporary
path that every process shares.  Under pytest-xdist in a fresh checkout
the workers do so at once: a worker can rename into place, and load, an
inode that another worker's linker is still writing.  The load then
fails (the worker runs on without the library), or a later call into the
library crashes the worker: a segmentation fault in
omm_tpu.native.all_uniform_u8, reached from omm_tpu.bake.finalize_items
in tests/test_torch_copies.py::test_finalize_items.

The port's test modules that call into the JAX package import
`jax_native_pinned`, a module-scoped autouse fixture.  It builds the same
source with the same flags once for all workers, under an fcntl lock,
into a file under build/ named by a digest of the source, the flags and
the host's CPU; the file appears by rename when the compiler has exited
and is never written again.  For the module, omm_tpu.native loads that
file; the loader's previous state comes back after the module, so the
JAX package's own tests see their loader as they left it.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "omm_tpu_native_ref")
SRC = os.path.join(ROOT, "omm_tpu", "native", "omm_native.cpp")
#: omm_tpu.native._build's flag sets, in the order it tries them
FLAGS = (("-O3", "-march=native", "-funroll-loops"), ("-O2",))


def _host_cpu() -> bytes:
    """The host's CPU flags: a -march=native build is named by them."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")),
                        "").encode()
    except OSError:  # pragma: no cover - non-Linux
        import platform
        return platform.processor().encode()


def private_library(src: str = SRC, out_dir: str = OUT_DIR):
    """Path of a finished build of `src` in `out_dir` (built here if no
    process has built it yet), or None where g++ builds it with neither
    flag set."""
    with open(src, "rb") as f:
        text = f.read()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for flags in FLAGS:
            key = hashlib.sha256(text + " ".join(flags).encode()
                                 + _host_cpu()).hexdigest()[:16]
            path = os.path.join(out_dir, f"libomm_native-{key}.so")
            if os.path.exists(path):
                return path
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                r = subprocess.run(["g++", *flags, "-pthread", "-shared",
                                    "-fPIC", src, "-o", tmp],
                                   capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                continue
            if r.returncode == 0:
                os.replace(tmp, path)
                return path
    return None


@pytest.fixture(autouse=True, scope="module")
def jax_native_pinned():
    """omm_tpu.native on the private build for the module's tests."""
    from omm_tpu import native as jn
    with jn._LOCK:
        saved = (jn._SO, jn._LIB, jn._TRIED)
    path = private_library(jn._SRC)
    if path is not None:
        # the loader rebuilds a library older than its source
        if os.path.getmtime(path) < os.path.getmtime(jn._SRC):
            os.utime(path)
        with jn._LOCK:
            jn._SO, jn._LIB, jn._TRIED = path, None, False
        if jn.get_lib() is None:
            raise RuntimeError(f"omm_tpu.native did not load {path}")
    yield path
    with jn._LOCK:
        jn._SO, jn._LIB, jn._TRIED = saved
