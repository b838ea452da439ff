"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` on first use (never at import) into the build directory
(:func:`pymbar_tpu_torch.config.build_dir`: ``pymbar_tpu_torch/_build/``
unless ``PYMBAR_TPU_TORCH_CACHE_DIR`` names another), named by a hash of
the source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source rebuilds and an unchanged one loads at once.
The library is loaded with ``ctypes``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from pymbar_tpu_torch import config

__all__ = ["NVCC_FLAGS", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS = {}


def _nvcc():
    candidates = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def build(name):
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists.

    Returns the path of the shared library.  The compiler's output (with
    ``-Xptxas -v``: registers, shared memory and spills per kernel) goes to
    ``<name>.log`` in the build directory.
    """
    src = _CSRC / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    build_dir = config.build_dir()
    out = build_dir / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = build_dir / f"lib{name}-{digest}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True,
        text=True,
    )
    (build_dir / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
