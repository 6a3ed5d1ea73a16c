"""Wrappers of the dense-adjacency kernels (``csrc/dense.cu``), their plain
PyTorch versions, and the chunked superstep loop of the dense engine.

- ``dense_forbid`` (K11) computes, for every uncolored row, the first
  color column below ``k`` that no neighbor holds — the JAX body's
  ``adj @ onehot(colors)`` and first fit, as a bitmask of the neighbors'
  colors over each uncolored row's adjacency, read once — into ``cand``
  (−1 for a colored or pad row; 0 for an uncolored row with no free
  column, which adds to the control block's fail count);
- ``dense_resolve`` (K12) keeps an uncolored row's candidate unless an
  uncolored neighbor with the same candidate beats it (higher degree, or
  the same degree and a lower id), writes the new colors into the other
  buffer, and folds the step into the status (FAILURE, SUCCESS, then
  STALLED once ``step + 1 >= max_steps``), flipping the buffer unless the
  step failed. On the card it keeps the candidates in shared memory as
  int16, so it takes Vp up to ``RESOLVE_MAX_VP`` (the engine's cap is
  16,384) and reads ``state`` and ``cand`` in 16-byte words.

The state is ``dgc_tpu.engine.dense_engine._attempt_kernel_dense``'s loop
carry on buffers: colors int32[2, Vp] (Vp = V padded to ``VERTEX_TILE``;
the pad entries −1), the bf16[Vp, Vp] 0/1 adjacency (pad rows and columns
zero), the int32[Vp] degrees (pads 0) and a control block of
``DCTRL_LEN`` slots.

For tensors on the CPU each wrapper runs its plain version
(``*_reference``); for tensors on a card it launches its kernel or raises
— it never falls back. ``launch_counts`` counts launches per kernel: a
wrapper adds one where it launches and nowhere else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dgc_tpu_torch.engine.base import AttemptStatus
from dgc_tpu_torch.kernels.superstep import (CHUNK_STEPS, INT32_MAX,
                                             _check_int32, _stream)

# control block slots (kD* in csrc/dense.cu)
DCTRL_STATUS, DCTRL_STEP, DCTRL_CUR, DCTRL_FAIL, DCTRL_UNCOL, \
    DCTRL_TICKET = range(6)
DCTRL_LEN = 6
# Vp's multiple (kVertexTile in csrc/dense.cu): K11's bulk copies and
# K12's 16-byte words divide a row evenly
VERTEX_TILE = 256
# the largest Vp K12 takes on the card (kResolveMaxVp in csrc/dense.cu): its
# candidates, below Vp, are int16 in shared memory
RESOLVE_MAX_VP = 32768
_RUNNING = int(AttemptStatus.RUNNING)

SOURCE = "dense.cu"

launch_counts = {"dense_forbid": 0, "dense_resolve": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def padded_size(v: int) -> int:
    """Vp: V rounded up to ``VERTEX_TILE`` (at least one tile)."""
    return max(VERTEX_TILE, -(-v // VERTEX_TILE) * VERTEX_TILE)


def dense_adjacency(indptr: np.ndarray, indices: np.ndarray, vp: int,
                    device) -> torch.Tensor:
    """The bf16[vp, vp] 0/1 adjacency of a CSR graph, built where it lives
    (no V² array on the host); pad rows and columns zero."""
    v = len(indptr) - 1
    degrees = np.diff(np.asarray(indptr)).astype(np.int64)
    rows = torch.repeat_interleave(torch.arange(v, device=device),
                                   torch.from_numpy(degrees).to(device))
    cols = torch.from_numpy(np.asarray(indices, np.int64)).to(device)
    adj = torch.zeros((vp, vp), dtype=torch.bfloat16, device=device)
    adj[rows, cols] = 1
    return adj


def new_dense_ctrl(device) -> torch.Tensor:
    """A control block for a fresh attempt: RUNNING at step 0, colors in
    buffer 0, counters cleared."""
    return torch.tensor([_RUNNING, 0, 0, 0, 0, 0], dtype=torch.int32,
                        device=device)


def new_dense_state(colors0: torch.Tensor) -> torch.Tensor:
    """int32[2, Vp] color buffers, both holding ``colors0``."""
    return colors0.to(torch.int32).unsqueeze(0).repeat(2, 1).contiguous()


# ---- plain versions ---------------------------------------------------------

def _edges(adj: torch.Tensor):
    return (adj != 0).nonzero(as_tuple=True)


def first_fit_reference(adj: torch.Tensor, colors: torch.Tensor, k: int):
    """``(cand, fail)`` for every row, as the JAX body computes them: the
    first column below ``k`` that no neighbor's color holds (0 when there
    is none, the argmax of all-false), and whether there is none."""
    rows, cols = _edges(adj)
    c = colors[cols].to(torch.int64)
    m = (c >= 0) & (c < k)
    forbidden = torch.zeros((adj.shape[0], k), dtype=torch.bool,
                            device=adj.device)
    forbidden[rows[m], c[m]] = True
    col = torch.arange(k, dtype=torch.int32, device=adj.device)
    first = torch.where(forbidden, k, col.unsqueeze(0)).amin(dim=1)
    fail = first == k
    return torch.where(fail, 0, first).to(torch.int32), fail


def keep_reference(adj: torch.Tensor, cand: torch.Tensor,
                   degrees: torch.Tensor) -> torch.Tensor:
    """Per row: no neighbor v with ``cand[v] >= 0``, the same candidate,
    that beats it (the JAX body's ``keep`` over K11's ``cand``)."""
    rows, cols = _edges(adj)
    du, dv = degrees[rows], degrees[cols]
    beats = (dv > du) | ((dv == du) & (cols < rows))
    bad = (cand[cols] >= 0) & (cand[cols] == cand[rows]) & beats
    keep = torch.ones(adj.shape[0], dtype=torch.bool, device=adj.device)
    keep[rows[bad]] = False
    return keep


def dense_forbid_reference(ctrl: torch.Tensor, state: torch.Tensor,
                           adj: torch.Tensor, cand: torch.Tensor, v: int,
                           k: int) -> None:
    """K11's plain version."""
    if int(ctrl[DCTRL_STATUS]) != _RUNNING:
        return
    colors = state[int(ctrl[DCTRL_CUR])]
    first, fail = first_fit_reference(adj, colors, k)
    uncol = (colors < 0) & (torch.arange(adj.shape[0], device=adj.device) < v)
    cand.copy_(torch.where(uncol, first, -1))
    ctrl[DCTRL_FAIL] += (uncol & fail).sum().to(torch.int32)


def resolve_status(failed: bool, uncolored: int, step: int,
                   max_steps: int) -> int:
    """The status after a step: FAILURE > SUCCESS > STALLED > RUNNING."""
    if failed:
        return int(AttemptStatus.FAILURE)
    if uncolored == 0:
        return int(AttemptStatus.SUCCESS)
    if step + 1 >= max_steps:
        return int(AttemptStatus.STALLED)
    return _RUNNING


def dense_resolve_reference(ctrl: torch.Tensor, state: torch.Tensor,
                            adj: torch.Tensor, cand: torch.Tensor,
                            degrees: torch.Tensor, v: int,
                            max_steps: int) -> None:
    """K12's plain version."""
    c = ctrl.tolist()
    if c[DCTRL_STATUS] != _RUNNING:
        return
    cur = c[DCTRL_CUR]
    failed = c[DCTRL_FAIL] != 0
    uncolored = 0
    if not failed:
        keep = keep_reference(adj, cand, degrees)
        src = state[cur, :v]
        new = torch.where(cand[:v] >= 0, torch.where(keep[:v], cand[:v], -1),
                          src)
        state[1 - cur, :v] = new
        uncolored = int((new < 0).sum())
    status = resolve_status(failed, uncolored, c[DCTRL_STEP], max_steps)
    ctrl.copy_(torch.tensor(
        [status, c[DCTRL_STEP] + 1, cur if failed else 1 - cur, 0, 0, 0],
        dtype=torch.int32))


# ---- kernel launches --------------------------------------------------------

def _library():
    from dgc_tpu_torch.kernels.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_dgc_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dgc_dense_forbid.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        lib.dgc_dense_forbid.restype = ci
        lib.dgc_dense_resolve.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.dgc_dense_resolve.restype = ci
        lib._dgc_bound = True
    return lib


def _check_dense(ctrl, state, adj, vectors, v: int) -> int:
    """Validate the shared operands; returns Vp."""
    device = adj.device
    _check_int32("ctrl", ctrl, device, 1)
    _check_int32("state", state, device, 2)
    for name, t in vectors.items():
        _check_int32(name, t, device, 1)
    vp = adj.shape[0]
    if adj.dtype != torch.bfloat16 or adj.dim() != 2 or adj.shape[1] != vp \
            or not adj.is_contiguous():
        raise ValueError(f"adj must be a contiguous bf16[Vp, Vp], got "
                         f"{adj.dtype} {tuple(adj.shape)}")
    if vp % VERTEX_TILE or vp == 0:
        raise ValueError(f"Vp={vp} is not a positive multiple of {VERTEX_TILE}")
    if ctrl.shape[0] != DCTRL_LEN or tuple(state.shape) != (2, vp):
        raise ValueError(f"ctrl must be [{DCTRL_LEN}] and state [2, {vp}]")
    if any(t.shape[0] != vp for t in vectors.values()):
        raise ValueError(f"vectors must be [{vp}]")
    if not 0 <= v <= vp:
        raise ValueError(f"v={v} outside [0, {vp}]")
    return vp


def dense_forbid(ctrl: torch.Tensor, state: torch.Tensor, adj: torch.Tensor,
                 cand: torch.Tensor, v: int, k: int) -> None:
    """K11; see the module docstring. ``k`` is the clamped budget (≥ 1).
    Runs on the current stream, does not synchronize."""
    device = adj.device
    if device.type == "cpu":
        return dense_forbid_reference(ctrl, state, adj, cand, v, k)
    if device.type != "cuda":
        raise ValueError(f"dense_forbid: unsupported device {device}")
    vp = _check_dense(ctrl, state, adj, {"cand": cand}, v)
    if not 1 <= k <= INT32_MAX:
        raise ValueError(f"k={k} outside [1, {INT32_MAX}]")
    rc = _library().dgc_dense_forbid(
        ctrl.data_ptr(), state.data_ptr(), adj.data_ptr(), cand.data_ptr(),
        vp, int(v), int(k), _stream(device))
    if rc != 0:
        raise RuntimeError(f"dense_forbid launch failed: CUDA error {rc}")
    launch_counts["dense_forbid"] += 1


def dense_resolve(ctrl: torch.Tensor, state: torch.Tensor, adj: torch.Tensor,
                  cand: torch.Tensor, degrees: torch.Tensor, v: int,
                  max_steps: int) -> None:
    """K12; see the module docstring. Runs on the current stream."""
    device = adj.device
    if device.type == "cpu":
        return dense_resolve_reference(ctrl, state, adj, cand, degrees, v,
                                       max_steps)
    if device.type != "cuda":
        raise ValueError(f"dense_resolve: unsupported device {device}")
    vp = _check_dense(ctrl, state, adj, {"cand": cand, "degrees": degrees}, v)
    if vp > RESOLVE_MAX_VP:
        raise ValueError(f"dense_resolve: Vp={vp} above {RESOLVE_MAX_VP}")
    if state.data_ptr() % 16 or cand.data_ptr() % 16:
        raise ValueError("dense_resolve: state and cand must be 16-byte "
                         "aligned")
    rc = _library().dgc_dense_resolve(
        ctrl.data_ptr(), state.data_ptr(), adj.data_ptr(), cand.data_ptr(),
        degrees.data_ptr(), vp, int(v), int(min(max_steps, INT32_MAX)),
        _stream(device))
    if rc != 0:
        raise RuntimeError(f"dense_resolve launch failed: CUDA error {rc}")
    launch_counts["dense_resolve"] += 1


def run_dense_steps(ctrl: torch.Tensor, state: torch.Tensor,
                    adj: torch.Tensor, cand: torch.Tensor,
                    degrees: torch.Tensor, v: int, k: int,
                    max_steps: int) -> list[int]:
    """Enqueue ``CHUNK_STEPS`` supersteps (K11 then K12 each) and read the
    control block back: the one host sync of the chunk. Steps enqueued
    after the attempt left RUNNING return at once on the card (and are
    skipped on the CPU)."""
    for _ in range(CHUNK_STEPS):
        dense_forbid(ctrl, state, adj, cand, v, k)
        dense_resolve(ctrl, state, adj, cand, degrees, v, max_steps)
        if ctrl.device.type == "cpu" and int(ctrl[DCTRL_STATUS]) != _RUNNING:
            break
    return ctrl.tolist()
