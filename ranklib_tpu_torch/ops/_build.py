"""Build-on-first-use for the port's native code.

Every shared library lands in ``ranklib_tpu_torch/_build/`` (git-ignored)
under a name keyed by a hash of its compiler command and source bytes, so
an edited source rebuilds and an unchanged one loads straight away. The
compiler writes to a per-process temporary name that is renamed into place,
so concurrent first uses (test workers) never load a half-written file.

The CUDA kernels (``csrc/*.cu``) build with ``nvcc`` for ``sm_90a`` into
one library with a plain C interface, loaded with ``ctypes``: no
``torch.utils.cpp_extension`` and no PyTorch headers, which keeps a cold
build to seconds. Only the CUDA branch of a kernel wrapper calls
:func:`load_kernels`, so hosts without ``nvcc`` import everything.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

from ranklib_tpu_torch.utils.errors import RankLibError

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC_DIR = os.path.join(_PKG, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")        # registers/spills land in the .log


def compile_shared(name: str, cmd, sources, deps=(),
                   timeout: float = 600.0) -> str:
    """Compile ``sources`` with ``cmd`` (compiler + flags, no ``-o``) into
    ``_build/<name>-<hash>.so`` unless it is already there; returns the
    path. ``deps`` (headers) only feed the hash. The compiler's output is
    kept beside the library as ``.log``. Raises RankLibError with that
    output when the compiler fails."""
    h = hashlib.sha256("\0".join(cmd).encode())
    for p in (*sources, *deps):
        with open(p, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([*cmd, "-o", tmp, *sources],
                              capture_output=True, text=True,
                              timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RankLibError(f"building {name} failed: {e}") from e
    if proc.returncode != 0:
        raise RankLibError(f"building {name} failed "
                           f"(rc={proc.returncode}):\n{proc.stderr}")
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then
    ``nvcc`` on ``PATH``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RankLibError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels build from ranklib_tpu_torch/csrc/*.cu at "
        "first use and need the CUDA toolkit")


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load every ``csrc/*.cu`` as one
    library. Callers declare ``argtypes`` for the functions they use."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    deps = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    path = compile_shared("kernels", (find_nvcc(), *NVCC_FLAGS), sources,
                          deps)
    return ctypes.CDLL(path)


def build_log(lib: ctypes.CDLL) -> str:
    """The compiler output kept beside a library built here."""
    with open(lib._name + ".log") as f:
        return f.read()
