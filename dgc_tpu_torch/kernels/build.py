"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source in ``dgc_tpu_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface — no PyTorch
headers, so a build takes seconds — under ``dgc_tpu_torch/_build/``
(git-ignored), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is. Nothing here
falls back: no ``nvcc``, a failed build or a failed load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # source name -> nvcc's output (ptxas -v)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "port's CUDA kernels are built from source at first use")
    return nvcc


def library_path(source: str) -> Path:
    # the shared headers are part of every source's build
    text = b"".join([(CSRC / source).read_bytes()]
                    + [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists; return its path."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log[source] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} (rc {proc.returncode}):\n"
                           f"{build_log[source]}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a torn file
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        _loaded[source] = lib
    return lib
