"""ctypes bindings for the native graph generator and post-pass walks (the
port's copy of ``dgc_tpu.native.bindings``).

``graphgen.cpp`` is a verbatim copy of ``dgc_tpu/native/graphgen.cpp``, so
at the same seed the port draws the same graphs and its post-pass walks
the same way as the JAX package. The shared library is built on demand
(one ``g++ -O3 -shared -fPIC`` call) the first time a native path is
asked for, into ``dgc_tpu_torch/_build/`` (git-ignored), named by a hash
of the source and the flags: an edited source rebuilds, an unchanged one
is loaded as it is. Where no toolchain exists, or the build or load
fails, every entry point returns None and the callers take their NumPy
paths — the JAX package's documented host behavior.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "graphgen.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
# -O3 without -march=native: a copied tree must never SIGILL on an older CPU
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_load_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdgcgraph-{digest[:16]}.so"


def _build(out: Path) -> bool:
    # pid-unique tmp: concurrent processes (test workers) may build at the
    # same time; each os.replace then installs a complete library, never a
    # half-written one
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _bind(lib) -> None:
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    i64, i32, f64, u64 = (ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
                          ctypes.c_uint64)
    sigs = {
        "dgc_generate_fast": (ctypes.c_void_p, [i64, f64, u64, i32]),
        "dgc_generate_reference": (ctypes.c_void_p, [i64, i32, u64, i64]),
        "dgc_generate_rmat": (ctypes.c_void_p,
                              [i64, f64, u64, f64, f64, f64, i32]),
        "dgc_relabel_csr": (ctypes.c_void_p, [i64, i32p, i32p, i32p]),
        "dgc_num_vertices": (i64, [ctypes.c_void_p]),
        "dgc_num_directed_edges": (i64, [ctypes.c_void_p]),
        "dgc_copy_csr": (None, [ctypes.c_void_p, i32p, i32p]),
        "dgc_free": (None, [ctypes.c_void_p]),
        "dgc_build_combined": (i32, [i64, i64p, i32p, i32p, i64, i64, i64,
                                     i32, i32p]),
        "dgc_reduce_top_class": (i32, [i64, i32p, i32p, i32p, i32, i32, i32,
                                       i64, ctypes.POINTER(i64)]),
        "dgc_greedy_color": (i32, [i64, i32p, i32p, i32p, i32p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _load():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        out = library_path()
        if not out.exists() and not _build(out):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(out))
            _bind(lib)
        except (OSError, AttributeError):
            _load_failed = True
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _resolve_seed(seed: int | None) -> int:
    """None → fresh OS entropy (matching random.Random(None) semantics);
    the C ABI needs a concrete uint64."""
    if seed is None:
        return int.from_bytes(os.urandom(8), "little")
    return int(seed) & 0xFFFFFFFFFFFFFFFF


def _extract(lib, handle):
    from dgc_tpu_torch.models.arrays import GraphArrays

    if not handle:  # NULL: the native generator failed (e.g. allocation)
        return None
    try:
        v = lib.dgc_num_vertices(handle)
        e = lib.dgc_num_directed_edges(handle)
        indptr = np.empty(v + 1, dtype=np.int32)
        indices = np.empty(e, dtype=np.int32)
        lib.dgc_copy_csr(handle, indptr, indices)
    finally:
        lib.dgc_free(handle)
    return GraphArrays(indptr=indptr, indices=indices)


def generate_fast_native(node_count: int, avg_degree: float,
                         seed: int | None = None,
                         max_degree: int | None = None):
    lib = _load()
    if lib is None:
        return None
    h = lib.dgc_generate_fast(node_count, avg_degree, _resolve_seed(seed),
                              -1 if max_degree is None else max_degree)
    return _extract(lib, h)


def generate_reference_native(node_count: int, max_degree: int,
                              seed: int | None = None,
                              max_retries_per_vertex: int | None = None):
    lib = _load()
    if lib is None:
        return None
    h = lib.dgc_generate_reference(
        node_count, max_degree, _resolve_seed(seed),
        -1 if max_retries_per_vertex is None else max_retries_per_vertex)
    return _extract(lib, h)


def generate_rmat_native(node_count: int, avg_degree: float,
                         seed: int | None = None, a: float = 0.57,
                         b: float = 0.19, c: float = 0.19,
                         max_degree: int | None = None):
    lib = _load()
    if lib is None:
        return None
    h = lib.dgc_generate_rmat(node_count, avg_degree, _resolve_seed(seed),
                              a, b, c, -1 if max_degree is None else max_degree)
    return _extract(lib, h)


def relabel_csr_native(indptr: np.ndarray, indices: np.ndarray,
                       perm: np.ndarray):
    """Degree-descending CSR relabel (row nr = old row perm[nr], neighbor
    ids mapped through inv(perm), sorted ascending) — bit-identical to the
    NumPy path in ``engine.bucketed.build_degree_buckets``. Returns
    ``(new_indptr int32[V+1], new_indices int32[E])`` or None when the
    native library is unavailable or fails."""
    lib = _load()
    if lib is None:
        return None
    v = int(indptr.shape[0]) - 1
    h = lib.dgc_relabel_csr(
        v, np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(indices, dtype=np.int32),
        np.ascontiguousarray(perm, dtype=np.int32))
    g = _extract(lib, h)
    return None if g is None else (g.indptr, g.indices)


def build_combined_native(indptr: np.ndarray, indices: np.ndarray,
                          degrees: np.ndarray, row0: int, nrows: int,
                          width: int, sentinel: int):
    """One-pass combined (neighbor | beats<<30) ELL table for relabeled CSR
    rows [row0, row0+nrows) — bit-identical to the NumPy ``csr_to_ell`` +
    ``beats_rule`` + ``encode_combined`` chain, without its full-table
    temporaries. Returns int32[nrows, width] or None when the native
    library is unavailable or fails."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((nrows, width), dtype=np.int32)
    rc = lib.dgc_build_combined(
        int(indptr.shape[0]) - 1,
        np.ascontiguousarray(indptr, dtype=np.int64),
        np.ascontiguousarray(indices, dtype=np.int32),
        np.ascontiguousarray(degrees, dtype=np.int32),
        int(row0), int(nrows), int(width), int(sentinel), out)
    return out if rc == 0 else None


def csr_fits_int32(indptr: np.ndarray) -> bool:
    """Whether a CSR is safe for the int32 native walks: ≥2^31 directed
    edges or vertices would silently truncate in the casts the native
    entry points perform, so callers take the Python paths instead."""
    i32max = np.iinfo(np.int32).max
    return int(indptr[-1]) <= i32max and int(indptr.shape[0]) - 1 <= i32max


def reduce_top_class_native(indptr: np.ndarray, indices: np.ndarray,
                            colors: np.ndarray, max_pair_tries: int,
                            chain_cap: int, kempe_max_class: int,
                            budget_remaining: int):
    """Native ``eliminate_top_class`` (see ``ops.reduce_colors``; the two
    are bit-identical at equal budgets).

    Returns ``(rc, improved_colors | None, budget_remaining)`` — rc 1:
    class eliminated; 0: a member resisted; -1: the library failed mid-run
    (``budget_remaining`` still counts the visits it spent). Returns None
    (a single value) when the library is unavailable or the CSR exceeds
    the int32 walk.
    """
    lib = _load()
    if lib is None or not csr_fits_int32(indptr):
        return None
    # one copy: the scratch the C walk may leave partially modified
    out = np.array(colors, dtype=np.int32, order="C", copy=True)
    budget = ctypes.c_int64(int(budget_remaining))
    rc = lib.dgc_reduce_top_class(
        int(indptr.shape[0]) - 1,
        np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(indices, dtype=np.int32),
        out, int(out.max()), int(max_pair_tries), int(chain_cap),
        int(kempe_max_class), ctypes.byref(budget))
    return int(rc), (out if rc == 1 else None), int(budget.value)


def greedy_color_native(indptr: np.ndarray, indices: np.ndarray,
                        order: np.ndarray) -> np.ndarray | None:
    """Sequential first-fit greedy in the given vertex order (bit-identical
    to ``engine.oracle.greedy_color`` given the same order). Returns
    int32[V] colors, or None when the library is unavailable or the CSR
    exceeds the int32 walk."""
    lib = _load()
    if lib is None or not csr_fits_int32(indptr):
        return None
    v = int(indptr.shape[0]) - 1
    out = np.empty(v, dtype=np.int32)
    rc = lib.dgc_greedy_color(
        v, np.ascontiguousarray(indptr, dtype=np.int32),
        np.ascontiguousarray(indices, dtype=np.int32),
        np.ascontiguousarray(order, dtype=np.int32), out)
    return out if rc >= 0 else None
