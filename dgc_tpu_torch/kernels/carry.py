"""Wrappers of the serve tier's device-resident carry kernels
(``csrc/carry.cu``) and their plain PyTorch versions.

With ``--device-carry`` a pool's carry and input stacks stay on the card
(``serve.engine._LanePool``):

- ``lane_seat`` (K17): a wave of seats, each one lane's table row and
  degrees (uploaded once into a staging buffer by the caller), scattered
  into its lane of the stacks, its ``k0`` and ``max_steps`` set and its
  reset flag raised (``dgc_tpu.serve.batched.seat_lane_kernel`` applied
  once per seat, in seat order);
- ``carry_permute`` (K18): a pool resize's carry move,
  ``out[slot][dst[i]] = old[slot][src[i]]`` into a fresh carry whose
  other rows are the idle lane's (``permute_carry_kernel`` over
  ``idle_carry``); ``out`` never aliases ``old``;
- ``inputs_resize`` (K19): row ``i`` of the new stacks is old lane
  ``src[i]``, or the class dummy where ``src[i]`` is past the old width;
  the reset flags all 0 (``resize_inputs_kernel``).

Their lane-mesh instances (the lane axis split over shards, each shard's
carry and stacks its own tensors; ``serve.batched``'s sharded section):

- ``carry_permute_mesh`` (K18's mesh instance): one new shard's fresh
  carry, each kept row gathered from its old shard (a row may cross
  shards), through a device table of the old shards' slot pointers;
- ``inputs_resize_mesh`` (K19's mesh instance): one new shard's stacks,
  likewise, the dummy past the old lanes.

For tensors on the CPU each wrapper runs its plain version; for tensors on
a card it launches its kernel or raises — it never falls back.
``launch_counts`` counts launches per kernel: a wrapper adds one where it
launches and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from dgc_tpu_torch.engine.base import AttemptStatus
from dgc_tpu_torch.kernels.superstep import (_check_int32, _stream,
                                             indexed_device)
from dgc_tpu_torch.layout import (CARRY_IDX, CARRY_K, CARRY_LEN, CARRY_P1,
                                  CARRY_P2, CARRY_PACKED, CARRY_PHASE,
                                  CARRY_ST2)

SOURCE = "carry.cu"

launch_counts = {"lane_seat": 0, "carry_permute": 0, "inputs_resize": 0,
                 "carry_permute_mesh": 0, "inputs_resize_mesh": 0}

WIDE = (CARRY_PACKED, CARRY_P1, CARRY_P2)  # int32[B, V] slots


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def idle_values(v: int) -> list:
    """Each carry slot's value in an idle lane: phase 2, k 1, the second
    result's status FAILURE, the slot list all dummy ``v``, everything
    else 0 (the rows K18 does not fill; ``serve.batched.idle_carry``)."""
    idle = [0] * CARRY_LEN
    idle[CARRY_PHASE], idle[CARRY_K] = 2, 1
    idle[CARRY_ST2] = int(AttemptStatus.FAILURE)
    idle[CARRY_IDX] = int(v)
    return idle


def slot_shape(j: int, b: int, v: int, a0: int) -> tuple:
    """The shape of carry slot ``j`` for ``b`` lanes of ``v`` rows and an
    ``a0``-wide slot list."""
    return (b, a0) if j == CARRY_IDX else (b, v) if j in WIDE else (b,)


def _last_seats(lanes) -> list:
    """The index of each lane's last seat, in seat order of those."""
    last = {int(lane): i for i, lane in enumerate(lanes)}
    return sorted(last.values())


# ---- plain versions ---------------------------------------------------------

def lane_seat_reference(comb, degrees, k0, max_steps, reset, lanes, s_comb,
                        s_degrees, s_k0, s_max_steps) -> None:
    """K17's plain version: ``seat_lane_kernel`` once per seat, in order,
    into the stacks in place."""
    for i, lane in enumerate(lanes):
        lane = int(lane)
        comb[lane] = s_comb[i]
        degrees[lane] = s_degrees[i]
        k0[lane] = int(s_k0[i])
        max_steps[lane] = int(s_max_steps[i])
        reset[lane] = 1


def carry_permute_reference(old, src, dst, b_new: int) -> list:
    """K18's plain version: a fresh idle carry of ``b_new`` lanes, then each
    kept row moved, row by row."""
    v, a0 = old[CARRY_PACKED].shape[1], old[CARRY_IDX].shape[1]
    device = old[0].device
    idle = idle_values(v)
    out = [torch.full(slot_shape(j, b_new, v, a0), idle[j],
                      dtype=torch.int32, device=device)
           for j in range(CARRY_LEN)]
    for s, d in zip(src, dst):
        for j in range(CARRY_LEN):
            out[j][int(d)] = old[j][int(s)]
    return out


def inputs_resize_reference(comb, degrees, k0, max_steps, src, dummy_comb,
                            dummy_k0: int, dummy_max_steps: int) -> tuple:
    """K19's plain version: the new stacks row by row, the dummy where the
    source is past the old width; reset all 0."""
    b_old, b_new = degrees.shape[0], len(src)
    device = degrees.device
    out = (torch.empty((b_new,) + tuple(comb.shape[1:]), dtype=torch.int32,
                       device=device),
           torch.empty((b_new, degrees.shape[1]), dtype=torch.int32,
                       device=device),
           torch.empty(b_new, dtype=torch.int32, device=device),
           torch.empty(b_new, dtype=torch.int32, device=device),
           torch.zeros(b_new, dtype=torch.int32, device=device))
    for i, s in enumerate(src):
        s = int(s)
        if 0 <= s < b_old:
            out[0][i], out[1][i] = comb[s], degrees[s]
            out[2][i], out[3][i] = k0[s], max_steps[s]
        else:
            out[0][i] = dummy_comb
            out[1][i] = 0
            out[2][i], out[3][i] = int(dummy_k0), int(dummy_max_steps)
    return out


def carry_permute_mesh_reference(olds, rows, b_new: int, device) -> list:
    """K18's mesh instance, plain: a fresh idle carry of ``b_new`` lanes
    on ``device``, row ``i`` old shard ``rows[i][0]``'s lane
    ``rows[i][1]`` (shard -1: idle)."""
    v, a0 = olds[0][CARRY_PACKED].shape[1], olds[0][CARRY_IDX].shape[1]
    idle = idle_values(v)
    out = [torch.full(slot_shape(j, b_new, v, a0), idle[j],
                      dtype=torch.int32, device=device)
           for j in range(CARRY_LEN)]
    for i, (shard, lane) in enumerate(rows):
        if shard >= 0:
            for j in range(CARRY_LEN):
                out[j][i] = olds[shard][j][lane].to(device)
    return out


def inputs_resize_mesh_reference(olds, src, dummy_comb, dummy_k0: int,
                                 dummy_max_steps: int, device) -> tuple:
    """K19's mesh instance, plain: new stacks of ``len(src)`` lanes on
    ``device``, row ``i`` old shard ``src[i][0]``'s lane ``src[i][1]``
    (shard -1: the dummy); reset all 0."""
    comb0, degrees0 = olds[0][0], olds[0][1]
    b_new = len(src)
    out = (torch.empty((b_new,) + tuple(comb0.shape[1:]), dtype=torch.int32,
                       device=device),
           torch.empty((b_new, degrees0.shape[1]), dtype=torch.int32,
                       device=device),
           torch.empty(b_new, dtype=torch.int32, device=device),
           torch.empty(b_new, dtype=torch.int32, device=device),
           torch.zeros(b_new, dtype=torch.int32, device=device))
    for i, (shard, lane) in enumerate(src):
        if shard >= 0:
            for o, t in zip(out[:4], olds[shard][:4]):
                o[i] = t[lane].to(device)
        else:
            out[0][i] = dummy_comb.to(device)
            out[1][i] = 0
            out[2][i], out[3][i] = int(dummy_k0), int(dummy_max_steps)
    return out


# ---- kernel launches --------------------------------------------------------

class _SeatArgs(ctypes.Structure):
    _fields_ = [("comb", ctypes.c_void_p), ("degrees", ctypes.c_void_p),
                ("k0", ctypes.c_void_p), ("max_steps", ctypes.c_void_p),
                ("reset", ctypes.c_void_p), ("stage_comb", ctypes.c_void_p),
                ("stage_degrees", ctypes.c_void_p),
                ("seats", ctypes.c_void_p), ("row", ctypes.c_longlong),
                ("v", ctypes.c_int), ("b", ctypes.c_int), ("n", ctypes.c_int)]


class _PermuteArgs(ctypes.Structure):
    _fields_ = [("old", ctypes.c_void_p * CARRY_LEN),
                ("out", ctypes.c_void_p * CARRY_LEN),
                ("rows", ctypes.c_void_p), ("idle", ctypes.c_int * CARRY_LEN),
                ("b_old", ctypes.c_int), ("b_new", ctypes.c_int),
                ("v", ctypes.c_int), ("a0", ctypes.c_int)]


class _ResizeArgs(ctypes.Structure):
    _fields_ = [("comb", ctypes.c_void_p), ("degrees", ctypes.c_void_p),
                ("k0", ctypes.c_void_p), ("max_steps", ctypes.c_void_p),
                ("out_comb", ctypes.c_void_p),
                ("out_degrees", ctypes.c_void_p),
                ("out_k0", ctypes.c_void_p),
                ("out_max_steps", ctypes.c_void_p),
                ("out_reset", ctypes.c_void_p), ("src", ctypes.c_void_p),
                ("dummy_comb", ctypes.c_void_p), ("row", ctypes.c_longlong),
                ("dummy_k0", ctypes.c_int), ("dummy_max_steps", ctypes.c_int),
                ("b_old", ctypes.c_int), ("b_new", ctypes.c_int),
                ("v", ctypes.c_int)]


class _PermuteMeshArgs(ctypes.Structure):
    _fields_ = [("old", ctypes.c_void_p), ("out", ctypes.c_void_p * CARRY_LEN),
                ("rows", ctypes.c_void_p), ("idle", ctypes.c_int * CARRY_LEN),
                ("n_old", ctypes.c_int), ("b_new", ctypes.c_int),
                ("v", ctypes.c_int), ("a0", ctypes.c_int)]


class _ResizeMeshArgs(ctypes.Structure):
    _fields_ = [("old", ctypes.c_void_p), ("out_comb", ctypes.c_void_p),
                ("out_degrees", ctypes.c_void_p),
                ("out_k0", ctypes.c_void_p),
                ("out_max_steps", ctypes.c_void_p),
                ("out_reset", ctypes.c_void_p), ("src", ctypes.c_void_p),
                ("dummy_comb", ctypes.c_void_p), ("row", ctypes.c_longlong),
                ("dummy_k0", ctypes.c_int), ("dummy_max_steps", ctypes.c_int),
                ("n_old", ctypes.c_int), ("b_new", ctypes.c_int),
                ("v", ctypes.c_int)]


def _library():
    from dgc_tpu_torch.kernels.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_dgc_bound", False):
        for name in ("dgc_lane_seat", "dgc_carry_permute",
                     "dgc_inputs_resize", "dgc_carry_permute_mesh",
                     "dgc_inputs_resize_mesh"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name, cls in (("dgc_seat_args_size", _SeatArgs),
                          ("dgc_permute_args_size", _PermuteArgs),
                          ("dgc_resize_args_size", _ResizeArgs),
                          ("dgc_permute_mesh_args_size", _PermuteMeshArgs),
                          ("dgc_resize_mesh_args_size", _ResizeMeshArgs)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            if fn() != ctypes.sizeof(cls):
                raise RuntimeError(f"csrc/carry.cu's {name[4:-5]} and "
                                   f"{cls.__name__} differ")
        lib._dgc_bound = True
    return lib


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _cuda(device, name: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")


def _map(values, device) -> torch.Tensor:
    return torch.tensor([int(x) for x in values], dtype=torch.int32,
                        device=device)


def lane_seat(comb, degrees, k0, max_steps, reset, lanes, s_comb, s_degrees,
              s_k0, s_max_steps) -> None:
    """K17: seat ``lanes[i]`` from the staged rows ``s_comb[i]`` (int32[n,
    V, W]) and ``s_degrees[i]`` (int32[n, V]), on the stacks' device, with
    budget ``s_k0[i]`` and ``s_max_steps[i]`` (host ints); the stacks
    (``comb`` int32[B, V, W], ``degrees`` int32[B, V], ``k0``,
    ``max_steps``, ``reset`` int32[B]) are written in place. A lane seated
    twice keeps its last seat. Runs on the current stream."""
    device = degrees.device
    if device.type == "cpu":
        return lane_seat_reference(comb, degrees, k0, max_steps, reset, lanes,
                                   s_comb, s_degrees, s_k0, s_max_steps)
    _cuda(device, "lane_seat")
    b, v = degrees.shape
    n = len(lanes)
    for name, t, shape in (("comb", comb, (b, v, comb.shape[-1])),
                           ("degrees", degrees, (b, v)), ("k0", k0, (b,)),
                           ("max_steps", max_steps, (b,)),
                           ("reset", reset, (b,)),
                           ("s_comb", s_comb, (n, v, comb.shape[-1])),
                           ("s_degrees", s_degrees, (n, v))):
        _check_int32(name, t, device, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if n == 0:
        return
    if not all(0 <= int(x) < b for x in lanes):
        raise ValueError(f"seat lanes {list(lanes)} outside 0..{b - 1}")
    keep = _last_seats(lanes)
    if len(keep) < n:
        s_comb, s_degrees = s_comb[keep].contiguous(), s_degrees[keep].contiguous()
    seats = _map([lanes[i] for i in keep] + [s_k0[i] for i in keep]
                 + [s_max_steps[i] for i in keep], device)
    args = _SeatArgs(comb.data_ptr(), degrees.data_ptr(), k0.data_ptr(),
                     max_steps.data_ptr(), reset.data_ptr(),
                     s_comb.data_ptr(), s_degrees.data_ptr(),
                     seats.data_ptr(), v * comb.shape[-1], v, b, len(keep))
    _raise_on(_library().dgc_lane_seat(ctypes.byref(args), _stream(device)),
              "lane_seat")
    launch_counts["lane_seat"] += 1


def carry_permute(old, src, dst, b_new: int) -> list:
    """K18: a fresh carry of ``b_new`` lanes (new tensors), row ``dst[i]``
    old lane ``src[i]`` (host ints; ``dst`` distinct), every other row the
    idle lane's. Runs on the current stream."""
    if len(old) != CARRY_LEN:
        raise ValueError(f"the carry has {CARRY_LEN} slots, got {len(old)}")
    if len(src) != len(dst) or len(set(int(d) for d in dst)) != len(dst):
        raise ValueError("carry_permute: src and dst must pair up and dst "
                         "must be distinct")
    b_old, v = old[CARRY_PACKED].shape
    a0 = old[CARRY_IDX].shape[1]
    if not (all(0 <= int(s) < b_old for s in src)
            and all(0 <= int(d) < b_new for d in dst)):
        raise ValueError(f"carry_permute: src {list(src)} or dst {list(dst)} "
                         f"out of range ({b_old} -> {b_new} lanes)")
    device = old[0].device
    if device.type == "cpu":
        return carry_permute_reference(old, src, dst, b_new)
    _cuda(device, "carry_permute")
    for j, t in enumerate(old):
        shape = slot_shape(j, b_old, v, a0)
        _check_int32(f"carry[{j}]", t, device, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"carry[{j}] must be {shape}, got "
                             f"{tuple(t.shape)}")
    out = [torch.empty(slot_shape(j, b_new, v, a0), dtype=torch.int32,
                       device=device) for j in range(CARRY_LEN)]
    rows = [-1] * b_new
    for s, d in zip(src, dst):
        rows[int(d)] = int(s)
    rows_t = _map(rows, device)
    args = _PermuteArgs()
    for j in range(CARRY_LEN):
        args.old[j] = old[j].data_ptr()
        args.out[j] = out[j].data_ptr()
    args.rows = rows_t.data_ptr()
    for j, x in enumerate(idle_values(v)):
        args.idle[j] = x
    args.b_old, args.b_new, args.v, args.a0 = b_old, b_new, v, a0
    _raise_on(_library().dgc_carry_permute(ctypes.byref(args),
                                           _stream(device)), "carry_permute")
    launch_counts["carry_permute"] += 1
    return out


def inputs_resize(comb, degrees, k0, max_steps, src, dummy_comb,
                  dummy_k0: int, dummy_max_steps: int) -> tuple:
    """K19: new stacks ``(comb, degrees, k0, max_steps, reset)`` of
    ``len(src)`` lanes (new tensors), row ``i`` old lane ``src[i]`` (host
    ints) or, where ``src[i]`` is past the old width, the dummy
    (``dummy_comb`` int32[V, W], zero degrees, ``dummy_k0``,
    ``dummy_max_steps``); reset all 0. Runs on the current stream."""
    device = degrees.device
    if device.type == "cpu":
        return inputs_resize_reference(comb, degrees, k0, max_steps, src,
                                       dummy_comb, dummy_k0, dummy_max_steps)
    _cuda(device, "inputs_resize")
    b_old, v = degrees.shape
    w = comb.shape[-1]
    b_new = len(src)
    for name, t, shape in (("comb", comb, (b_old, v, w)),
                           ("degrees", degrees, (b_old, v)),
                           ("k0", k0, (b_old,)),
                           ("max_steps", max_steps, (b_old,)),
                           ("dummy_comb", dummy_comb, (v, w))):
        _check_int32(name, t, device, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if b_new < 1:
        raise ValueError("inputs_resize: no lanes")
    out = (torch.empty((b_new, v, w), dtype=torch.int32, device=device),
           torch.empty((b_new, v), dtype=torch.int32, device=device),
           torch.empty(b_new, dtype=torch.int32, device=device),
           torch.empty(b_new, dtype=torch.int32, device=device),
           torch.empty(b_new, dtype=torch.int32, device=device))
    src_t = _map(src, device)
    args = _ResizeArgs(comb.data_ptr(), degrees.data_ptr(), k0.data_ptr(),
                       max_steps.data_ptr(), *(t.data_ptr() for t in out),
                       src_t.data_ptr(), dummy_comb.data_ptr(), v * w,
                       int(dummy_k0), int(dummy_max_steps), b_old, b_new, v)
    _raise_on(_library().dgc_inputs_resize(ctypes.byref(args),
                                           _stream(device)), "inputs_resize")
    launch_counts["inputs_resize"] += 1
    return out


def _table(rows, device) -> torch.Tensor:
    """The old shards' pointers as an int64 table on ``device``."""
    return torch.tensor(rows, dtype=torch.int64, device=device)


def _row_map(rows, device) -> torch.Tensor:
    """``(shard, lane)`` pairs as the int32[2, B_new] map the kernels read."""
    return _map([r[0] for r in rows] + [r[1] for r in rows], device)


def _check_rows(rows, n_old: int, b_olds: list, name: str) -> None:
    for shard, lane in rows:
        if shard >= 0 and not (shard < n_old and 0 <= lane < b_olds[shard]):
            raise ValueError(f"{name}: row ({shard}, {lane}) outside the old "
                             f"shards {b_olds}")


def carry_permute_mesh(olds, rows, b_new: int, device) -> list:
    """K18's mesh instance: a fresh carry of ``b_new`` lanes (new tensors on
    ``device``, one new shard), row ``i`` old shard ``rows[i][0]``'s lane
    ``rows[i][1]`` (host ints; shard -1: the idle lane's values). ``olds``
    is every old shard's carry. Runs on the device's current stream."""
    device = indexed_device(device)
    if len(rows) != b_new:
        raise ValueError(f"carry_permute_mesh: {len(rows)} rows for {b_new} "
                         f"lanes")
    if any(len(c) != CARRY_LEN for c in olds):
        raise ValueError(f"each old shard's carry has {CARRY_LEN} slots")
    _check_rows(rows, len(olds), [c[CARRY_PACKED].shape[0] for c in olds],
                "carry_permute_mesh")
    if device.type == "cpu":
        return carry_permute_mesh_reference(olds, rows, b_new, device)
    _cuda(device, "carry_permute_mesh")
    v, a0 = olds[0][CARRY_PACKED].shape[1], olds[0][CARRY_IDX].shape[1]
    for s, old in enumerate(olds):
        b_old = old[CARRY_PACKED].shape[0]
        for j, t in enumerate(old):
            shape = slot_shape(j, b_old, v, a0)
            _check_int32(f"shard {s} carry[{j}]", t, t.device, len(shape))
            if t.device.type != "cuda" or tuple(t.shape) != shape:
                raise ValueError(f"shard {s} carry[{j}] must be {shape} on a "
                                 f"card, got {tuple(t.shape)} on {t.device}")
    out = [torch.empty(slot_shape(j, b_new, v, a0), dtype=torch.int32,
                       device=device) for j in range(CARRY_LEN)]
    table = _table([[t.data_ptr() for t in old] for old in olds], device)
    rows_t = _row_map(rows, device)
    args = _PermuteMeshArgs()
    args.old = table.data_ptr()
    for j in range(CARRY_LEN):
        args.out[j] = out[j].data_ptr()
    args.rows = rows_t.data_ptr()
    for j, x in enumerate(idle_values(v)):
        args.idle[j] = x
    args.n_old, args.b_new, args.v, args.a0 = len(olds), b_new, v, a0
    _raise_on(_library().dgc_carry_permute_mesh(ctypes.byref(args),
                                                _stream(device)),
              "carry_permute_mesh")
    launch_counts["carry_permute_mesh"] += 1
    return out


def inputs_resize_mesh(olds, src, dummy_comb, dummy_k0: int,
                       dummy_max_steps: int, device) -> tuple:
    """K19's mesh instance: new stacks ``(comb, degrees, k0, max_steps,
    reset)`` of ``len(src)`` lanes (new tensors on ``device``, one new
    shard), row ``i`` old shard ``src[i][0]``'s lane ``src[i][1]`` (host
    ints) or, for shard -1, the dummy (``dummy_comb`` int32[V, W] on
    ``device``, zero degrees, ``dummy_k0``, ``dummy_max_steps``); reset all
    0. ``olds`` is every old shard's ``(comb, degrees, k0, max_steps)``.
    Runs on the device's current stream."""
    device = indexed_device(device)
    b_new = len(src)
    if b_new < 1:
        raise ValueError("inputs_resize_mesh: no lanes")
    _check_rows(src, len(olds), [o[1].shape[0] for o in olds],
                "inputs_resize_mesh")
    if device.type == "cpu":
        return inputs_resize_mesh_reference(olds, src, dummy_comb, dummy_k0,
                                            dummy_max_steps, device)
    _cuda(device, "inputs_resize_mesh")
    v, w = olds[0][1].shape[1], olds[0][0].shape[-1]
    for s, old in enumerate(olds):
        b_old = old[1].shape[0]
        for name, t, shape in (("comb", old[0], (b_old, v, w)),
                               ("degrees", old[1], (b_old, v)),
                               ("k0", old[2], (b_old,)),
                               ("max_steps", old[3], (b_old,))):
            _check_int32(f"shard {s} {name}", t, t.device, len(shape))
            if t.device.type != "cuda" or tuple(t.shape) != shape:
                raise ValueError(f"shard {s} {name} must be {shape} on a "
                                 f"card, got {tuple(t.shape)} on {t.device}")
    _check_int32("dummy_comb", dummy_comb, device, 2)
    if tuple(dummy_comb.shape) != (v, w):
        raise ValueError(f"dummy_comb must be {(v, w)}, got "
                         f"{tuple(dummy_comb.shape)}")
    out = (torch.empty((b_new, v, w), dtype=torch.int32, device=device),
           torch.empty((b_new, v), dtype=torch.int32, device=device),
           torch.empty(b_new, dtype=torch.int32, device=device),
           torch.empty(b_new, dtype=torch.int32, device=device),
           torch.empty(b_new, dtype=torch.int32, device=device))
    table = _table([[t.data_ptr() for t in old[:4]] for old in olds], device)
    src_t = _row_map(src, device)
    args = _ResizeMeshArgs(table.data_ptr(), *(t.data_ptr() for t in out),
                           src_t.data_ptr(), dummy_comb.data_ptr(), v * w,
                           int(dummy_k0), int(dummy_max_steps), len(olds),
                           b_new, v)
    _raise_on(_library().dgc_inputs_resize_mesh(ctypes.byref(args),
                                                _stream(device)),
              "inputs_resize_mesh")
    launch_counts["inputs_resize_mesh"] += 1
    return out
