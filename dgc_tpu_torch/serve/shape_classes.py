"""Shape classes: pad request graphs onto a bounded ladder of kernels.

XLA compiles one executable per static shape, and the single-graph
engines derive their static schedule from each graph's degree
distribution — so a request stream of novel graphs pays a compile per
request. The serving path instead snaps every graph onto a small
geometric ladder of ``(V_pad, W_pad)`` **shape classes**: vertices pad
with isolated (degree-0) dummy rows, ELL rows pad with the sentinel, and
the batched kernel is compiled once per class (× batch pad), so
arbitrary streams hit a bounded executable set.

Padding is exact, not approximate: a dummy vertex is confirmed color 0
by the round-1 specialization, contributes nothing to any fail/active
count or forbidden set (its row is all sentinel, and no real row's
neighbor list points at it), and the sentinel slot holds the −1 state —
so a padded member's per-superstep evolution over its real rows is
bit-identical to the unpadded graph's (``serve.batched`` docstring for
the full argument).

Width classes stop at 1023 so the full-budget color window fits the
engines' 32-plane cap (``engine.bucketed.MAX_WINDOW_PLANES`` — windows
that cover every width are what makes the batched kernel's single
window bit-identical to the bucketed engines' per-bucket windows).
Graphs exceeding the ladder fall back to the single-graph path
(``serve.engine``); they are served, just not batched.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dgc_tpu_torch.engine.bucketed import encode_combined
from dgc_tpu_torch.models.arrays import GraphArrays, csr_to_ell
from dgc_tpu_torch.ops.bitmask import num_planes_for
from dgc_tpu_torch.ops.speculative import beats_rule

# width rung 1023 (not 1024): planes = ceil((W+1)/32) must stay ≤ 32 so
# the class window is never capped (module docstring)
_DEFAULT_V_RUNGS = (1 << 11, 1 << 13, 1 << 15, 1 << 17, 1 << 19)
_DEFAULT_W_RUNGS = (8, 16, 32, 64, 128, 256, 512, 1023)


@dataclass(frozen=True)
class ShapeClass:
    """One compiled-kernel shape: ``V_pad`` padded rows × ``W_pad`` ELL
    columns, with the full-window plane count ``planes``."""

    v_pad: int
    w_pad: int

    @property
    def planes(self) -> int:
        return num_planes_for(self.w_pad + 1)

    @property
    def name(self) -> str:
        return f"v{self.v_pad}w{self.w_pad}"

    def entries(self) -> int:
        """Per-member gather footprint (the padding-waste denominator)."""
        return self.v_pad * self.w_pad


class ShapeLadder:
    """The geometric ``(V_pad, W_pad)`` grid requests snap onto."""

    def __init__(self, v_rungs: tuple = _DEFAULT_V_RUNGS,
                 w_rungs: tuple = _DEFAULT_W_RUNGS):
        if not v_rungs or not w_rungs:
            raise ValueError("shape ladder needs at least one rung per axis")
        if list(v_rungs) != sorted(set(int(v) for v in v_rungs)) or \
                list(w_rungs) != sorted(set(int(w) for w in w_rungs)):
            raise ValueError(
                f"shape ladder rungs must be strictly increasing, got "
                f"v={v_rungs!r} w={w_rungs!r}")
        if num_planes_for(int(w_rungs[-1]) + 1) > 32:
            raise ValueError(
                f"widest width rung {w_rungs[-1]} needs more than 32 bitmask "
                f"planes; cap rungs at 1023 (module docstring)")
        self.v_rungs = tuple(int(v) for v in v_rungs)
        self.w_rungs = tuple(int(w) for w in w_rungs)

    def class_for(self, num_vertices: int,
                  max_degree: int) -> ShapeClass | None:
        """Smallest class fitting the graph, or None (single-graph
        fallback). Width must fit ``max_degree`` exactly — the ELL rows
        are real neighbor lists, never truncated."""
        if num_vertices < 1:
            return None
        v_pad = next((r for r in self.v_rungs if r >= num_vertices), None)
        w_pad = next((r for r in self.w_rungs if r >= max(max_degree, 1)),
                     None)
        if v_pad is None or w_pad is None:
            return None
        return ShapeClass(v_pad, w_pad)

    def classes(self) -> list[ShapeClass]:
        return [ShapeClass(v, w) for v in self.v_rungs for w in self.w_rungs]


DEFAULT_LADDER = ShapeLadder()


def stage_schedule_for(cls: ShapeClass, spec="auto"):
    """The staged-frontier-ladder schedule a shape class's batched
    kernels compile (``serve.batched`` ``stages`` static arg), or None
    for the plain full-table kernel.

    ``spec``: ``"auto"`` derives the class ladder from the single-graph
    engine's machinery (``engine.compact.class_stage_schedule`` — one
    flat bucket of ``v_pad × w_pad``, so the serve ladder and the
    engine ladder share ``default_stages`` and the validity rule);
    ``"off"`` disables staging (the full-table A/B arm); an explicit
    stages tuple is validated and applied to this class as-is (tuned
    per-class ladders, tests). A derived ladder with no compaction
    stage (small classes below the staging floor) normalizes to None so
    the compiled kernel is byte-identical to the unstaged one."""
    if spec == "off":
        return None
    from dgc_tpu_torch.engine.compact import class_stage_schedule

    explicit = None if spec == "auto" else tuple(
        (None if s is None else int(s), int(t)) for s, t in spec)
    stages = class_stage_schedule(cls.v_pad, cls.w_pad,
                                  stages=explicit)["stages"]
    if all(scale is None for scale, _ in stages):
        return None
    return stages


@dataclass
class ServeMember:
    """One request graph padded into its shape class.

    ``comb`` is the combined (neighbor id | beats bit) table in the
    ORIGINAL vertex id order — the (degree desc, id asc) priority of
    ``beats_rule`` is invariant under the bucketed engines' stable
    degree-descending relabeling, which is exactly why the batched
    kernel's colors land directly in original ids yet match the
    relabeled engines bit for bit (``serve.batched`` docstring)."""

    arrays: GraphArrays
    cls: ShapeClass
    comb: np.ndarray        # int32[V_pad, W_pad]
    degrees: np.ndarray     # int32[V_pad] (0 beyond the real rows)
    k0: int                 # max_degree + 1 (the reference's budget start)
    max_steps: int          # the single-graph default 2·V_real + 4

    @property
    def num_vertices(self) -> int:
        return self.arrays.num_vertices


def pad_member(arrays: GraphArrays, cls: ShapeClass,
               max_steps: int | None = None) -> ServeMember:
    """Pad ``arrays`` into ``cls`` (module docstring exactness contract)."""
    v = arrays.num_vertices
    if v > cls.v_pad or arrays.max_degree > cls.w_pad:
        raise ValueError(
            f"graph V={v} maxdeg={arrays.max_degree} does not fit shape "
            f"class {cls.name}")
    sentinel = cls.v_pad
    nbrs, deg = csr_to_ell(arrays.indptr, arrays.indices, width=cls.w_pad,
                           sentinel=sentinel)
    nbrs_pad = np.full((cls.v_pad, cls.w_pad), sentinel, np.int32)
    nbrs_pad[:v] = nbrs
    deg_pad = np.zeros(cls.v_pad, np.int32)
    deg_pad[:v] = deg
    # sentinel degree −1: never beats anything (beats_rule is strict)
    deg_ext = np.concatenate([deg_pad, np.array([-1], np.int32)])
    beats = beats_rule(deg_ext[nbrs_pad], nbrs_pad, deg_pad[:, None],
                       np.arange(cls.v_pad, dtype=np.int32)[:, None])
    comb = encode_combined(nbrs_pad, beats)
    return ServeMember(
        arrays=arrays, cls=cls, comb=comb, degrees=deg_pad,
        k0=int(arrays.max_degree) + 1,
        max_steps=int(max_steps) if max_steps is not None else 2 * v + 4,
    )


def dummy_member(cls: ShapeClass) -> ServeMember:
    """Batch-pad filler: an all-isolated member that confirms everything
    to color 0 in its first superstep and exits both phases immediately
    (its slots in the batched carry go inert after ~2 loop rounds)."""
    empty = GraphArrays(indptr=np.zeros(2, np.int32),
                        indices=np.zeros(0, np.int32))
    return ServeMember(
        arrays=empty, cls=cls,
        comb=np.full((cls.v_pad, cls.w_pad), cls.v_pad, np.int32),
        degrees=np.zeros(cls.v_pad, np.int32), k0=1, max_steps=4,
    )


def pad_ladder(batch_max: int, min_pad: int = 1) -> tuple:
    """Every batch pad a ``batch_max``-lane scheduler can dispatch at,
    widest first: the power-of-two ladder (the adaptive lane pool grows
    by doubling and shrinks to the live set's pad; sync mode pads
    partial batches up to pow2), plus ``batch_max`` itself when it is
    not a power of two (sync full batches dispatch unpadded at it).
    This IS the compiled-kernel pad set per class — what
    ``--warm-classes`` pre-compiles.

    ``min_pad`` (a power of two) floors the ladder: a lane-sharded
    scheduler (``--mesh-devices``) never dispatches below the mesh size
    — its pools pad lanes in mesh multiples and every dispatch is a
    power-of-two pad, so the narrow rungs (and the non-pow2
    ``batch_max`` pad) would compile executables that never run."""
    min_pad = max(1, int(min_pad))
    b = 1 << max(0, (int(batch_max) - 1).bit_length())
    b = max(b, min_pad)
    pads = []
    while b >= min_pad:
        pads.append(b)
        b //= 2
    if min_pad == 1 and batch_max not in pads:
        pads.append(int(batch_max))
        pads.sort(reverse=True)
    return tuple(pads)


def padding_waste(members: list, cls: ShapeClass, b_pad: int) -> float:
    """Fraction of the dispatched ``b_pad × V_pad × W_pad`` gather
    footprint that is padding (dummy members, dummy rows, ELL pad slots)
    rather than real neighbor entries — the batch-occupancy telemetry."""
    total = b_pad * cls.entries()
    real = sum(int(m.arrays.num_directed_edges) for m in members)
    return round(1.0 - real / total, 4) if total else 0.0
