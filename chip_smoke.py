"""Drive the PyTorch port (``dgc_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # one card: every phase below
    python3 chip_smoke.py --mesh-cards    # two cards or more: the lane
                                          # mesh across them alone (5.)

Phases, each of which fails the run (non-zero exit, no result line):

0. Build: every CUDA source of the port, one ``nvcc`` each, all started
   together.
1. Kernels vs plain, exact. The superstep kernel (K1) and the
   loop-control kernel (K2) on seeded random blocks — plane counts 1, 2,
   3, 32, 40; budgets 1, 31, 32, 33, 32P, above the window; exact and
   capped windows; rows full of pad sentinels; either state buffer
   current; an attempt no longer running; then K1 in every team mode
   (``K1_WIDTHS``: a lane, 2-32 lanes, a warp, a block, and a
   65,536-wide row of 40,000 real entries) on ragged rows of every real
   length, uncolored, fresh and confirmed words, 1 to 40 planes (a
   widened window), budgets 1 to past the window, both fail gates, and
   50 launches of a lane and a block case on one input, each the plain
   bytes. The compact engine's kernels:
   K3 (compaction) at densities from none to all and pads below, at and
   above the active count, at V one below, at and one above a round of
   2,048 items, with every alignment of the other buffer, more rounds
   than one wave of blocks, a pad far above the count and row offsets,
   every launch on one scratch; K4 (stage rows) over stage layouts with 33-
   and 17-plane ranges; K5 (segmented superstep) over those slot lists
   and over row spans with covering and capped windows, at budgets 1 to
   past every window, live and in each way a stage stops; K6 (stage
   finish) over 300 random loop carries with and without the ring and a
   hub region's live table. The hub kernels K7 (branch and slot lists)
   and K8 (the branches' rows) on 72 random hub regions: every ladder and
   branch, captures that hold and fail, 1-, 32- and mixed-plane windows,
   each row walked up to its real length. K5 again at every flat
   width from 1 to 256 (every lane-group size) on ragged rows, over
   spans and slot lists, covering and one-plane windows. K8 again on wide
   hub rows from half its block width to eight times it and a
   65,536-wide row of 40,000 real entries (items a warp and a block
   each), every branch, windows of 1 to 64 planes. K5 and K8 (and their recording variants)
   each replayed 50 times on one input: every launch the plain bytes.
   The attempt block's K9 (record) and K10 (start) on 240 random blocks:
   every status, open, done and full blocks, rings whose brackets hold
   the budget in no, one or several slots, 1 to 140,000 vertices. The
   dense engine's K11 (forbidden colors as a bitmask, first fit) and
   K12 (conflicts, new colors, status) on random adjacencies of 1 to
   5,000 vertices (on and off the 256-vertex tile, isolated rows, hub rows
   whose first fit lies in a late word of the mask): colors with no, some
   and all −1s, either buffer current, budgets from 1 to 2,432, failing
   and stalling steps, an attempt no longer running; and rows whose first
   free color is 32, 40, 64 (every color below 64 taken) and 2,431 (the
   last bit of a 2,432-bit mask) at budgets on either side, a row whose
   neighbors' colors all lie at or past 2,432, and a step with no
   uncolored row. K12 alone on drawn candidates (``_k12_cases``) at 1,003,
   4,101 and 16,384 vertices (off a 16-byte word and the tile, hub rows of
   thousands, candidates and degrees near 16,383 at the last): a row whose
   only beater sits in the last word of the graph's columns, one beaten in
   its own word at equal degree by a lower id, one not beaten by a higher
   id, one whose same-candidate neighbor is colored, a stalling and a
   failed step. The recording variants (B11, in-kernel telemetry):
   K2 writing rows into buffers that hold the step or not; K5 and K8
   filling the unconf vector over the cases above (every hub branch); K6
   writing rows from 300 random loop carries and live tables, its clock
   on and off; K9 closing an attempt's span into a stack and K10
   starting the next. Every column is exact but the timestamp, which
   must be −1 where the plain version's is and a masked clock reading
   where it is not. The serve tier's K16 (lane reset), K14 (lane
   compaction), K13 (batched superstep) and K15 (lane finish) on seeded
   random lanes laid out as ``pad_member`` lays them out (a row's real
   entries, then the sentinel): 1 to 8 lanes of widths 8, 32, 64 and
   1,023 (1 to 32 planes; K13's groups of 1, 2 and 32 lanes a row), 300
   to 40,000 rows (K13's staged instance and its global one; each of
   its paths, gathers from the staged state and from device memory, must
   run, as its launch plan says), dummy lanes, lanes in every phase, dead
   and reset lanes, random rungs and slot lists, forced staged rungs,
   timing off and on, with and without random spec and cancel vectors
   (K16 must kill a lane and spare a cancelled reset one); every buffer
   is compared after every launch, the clock slots by the same rule; then
   K13 and K15 each replayed 50 times on one input of 8 lanes, of 1,000
   lanes (more than K13's blocks: a block stages its lanes one after
   another) and of 40,000 rows. The device-resident carry's K17
   (lane seat), K18 (carry permute) and K19 (inputs resize) on seeded
   random stacks and carries of classes v2048w8, v2048w1023 and v32768w32
   at 1, 2, 8 and 32 lanes: seats of one lane and of every lane (one twice),
   permutes keeping no, some and all lanes in random order at the same
   width, ×2 and ÷4, resizes ×2 and ÷4 with sources past the old width.
   The lane mesh's kernels (B12g): the partial K16/K15, the last shard's
   folding in its tail (K26's fold), on meshes of 2, 4 and 8 slots on
   cuda:0 (lanes of widths 8 and 64, staged or not, the clock and the
   speculation vectors on in some, the last shard all dead lanes), every
   shard's buffers compared after every launch, every control block
   against the plain partials plus the plain fold, the card's folds
   counted against the plain ones;
   the sharded seat (K17 a shard), permute and resize (the mesh K18/K19)
   growing, keeping and shrinking, kept lanes crossing shards, against
   the same twins on CPU slots.
2. Engines vs the CPU: ``ell-compact``, ``ell-bucketed`` and ``ell`` on a
   20k-vertex uniform graph (and ``ell-compact`` at ``flat_cap=4``: the
   hub ladder's ``compact`` branch), ``ell-compact`` on a 20k RMAT graph
   hub-free, at the default knobs and at forced knobs (every conditioned
   branch), and ``ell-bucketed`` there, jump and strict mode: every
   attempt's (k, status, supersteps, colors_used) and the final colors
   equal the ``device="cpu"`` run byte for byte; so do single attempts
   (and the compact engine's sweeps) on K40 under a 1-plane window cap,
   on isolated vertices, with compaction stages at that size, and at
   budgets below 1. One more sweep of the forced-knob and ``flat_cap=4``
   cases, held against the plain versions, must take the hub branches
   that case exists for (rebase, pruned, shrink, pruned2; compact). Every
   ``ell-compact`` case also runs the blocked driver on the card at 2 and
   4 attempts a block, jump and strict, against the same CPU run. The
   dense engine on a 2,000-vertex uniform and RMAT graph, jump and
   strict, and single attempts below 1, above kmax (equal to the k0
   attempt) and under a ``max_steps`` that stalls. Then telemetry on:
   ``ell-compact`` on the 20k uniform and RMAT graphs (default and forced
   knobs), sweeps with the card's clock and blocked runs at 4, and
   ``ell-bucketed`` and ``ell`` attempts: every result and trajectory
   equals the CPU's but for ``step_us``, which must be −1 first and
   non-negative after; telemetry off gives the same results. The serve
   tier's ``batched_sweep`` and ``batched_slice`` on a v8192w32 uniform
   batch and a v2048w1023 RMAT batch, each with a forced 3-rung ladder:
   the sweep, slices of 2 and a lane seated mid-ladder must equal the
   same calls on the CPU in every carry slot, the slices the sweep, and
   the seated lane its graph's own sweep. The scheduler with
   ``device_carry=True`` on 41 v2048w16 graphs arriving 1, 7 and 33 at a
   time (the pool grows 1 → 8 → 32 and shrinks; K17-K19 must launch)
   against its CPU run, graph by graph, each slice's d2h the scheduling
   scalars and the finished lanes' result rows; and a depth-3 strict
   ``SpeculativeMinimalKEngine`` sweep of a 20k graph on a 4-lane
   device-carry pool with three jump requests of its class arriving
   mid-window: every result equal to its sequential run on the card, some
   speculative lane preempted.
3. The main paths at full size: the CLI's calls (``cli.load_graph``,
   ``cli.make_engine``, ``cli.sweep``, ``Graph.save_coloring``) on a
   1M-vertex uniform graph of average degree 16 (``--max-degree 32
   --gen-method fast``) for ``ell-compact`` (the CLI default), then
   ``ell-bucketed`` and ``ell``; and on a 1M-vertex RMAT graph (``--gen-method
   rmat``, Δ 38,142: a hub region) for ``ell-compact`` and
   ``ell-bucketed``. Both graphs are drawn by the C++ generators, as
   ``dgc_tpu.cli`` draws them: the run fails when the native library does
   not build or a draw's sha256 is not the pinned one (``DRAW_SHA256``). The launch counts are zeroed just before each sweep
   and read just after, and each backend must launch every kernel of its
   path (K7 and K8 on RMAT only); the coloring must validate, and
   ``ell-compact``'s attempts and swept colors must equal
   ``ell-bucketed``'s. Then each kernel is held against its plain version
   at the shapes of that path and timed there: K1 and K2 at a first and
   a mid-attempt superstep, K1 on each bucket alone (``k1_by_bucket``),
   and on the RMAT ``ell-bucketed`` path over the sweep's attempts
   replayed with every K1 launch held, then profiled (``k1_sweep_ms``
   beside the bound over the same launches); K3-K8 at every call of one
   more ``sweep`` and
   one more ``attempt`` of the compact engine (a test double over their
   wrappers), K3-K6 timed on the uniform sweep's first stage inputs (K3
   replayed 50 times there first, each launch held), K7
   and K8 over the RMAT sweep's launches; the branches each hub bucket
   took are counted, K8 is timed on each hub bucket alone
   (``k8_by_bucket``) and K5's launches are split into the full table
   and the stages (``k5_split``). Then ``ell-compact`` again through the
   CLI's calls with ``--attempts-per-dispatch``: on 1M uniform jump and
   strict (from k0 = 33), sequential and at 4 a block, on 1M RMAT jump,
   sequential and at 4; each blocked sweep must equal its sequential one,
   launch K9 and K10 and bring no row of V words home between the
   attempts of a block. K9 and K10 are held against their plain versions
   over one more block of each jump sweep and timed there. The recording
   variants are held and timed beside them on the same inputs (K2 on the
   bucketed shapes, K5 and K6 on the full-table superstep, K9 and K10 on
   the held block) and over one more held and one more profiled sweep
   with telemetry on (K5, K6, K8). Then the sharded engines through the
   CLI's calls at world size 1 under NCCL: ``sharded`` and
   ``sharded-bucketed`` on the 1M uniform draw, ``sharded-bucketed`` on
   the 1M RMAT draw; the launch counts, zeroed just before each sweep and
   read just after, must show every kernel of the path (K20-K22; K21,
   K22 and K5/K7/K8 over the bucket slices), and the coloring JSON and
   the attempts must be the ``ell`` (``ell-bucketed``) run's on the same
   draw; K20-K22 timed there with the collectives of a superstep. One
   sweep of each engine as shard 3 of 4 of the 1M tables (the other
   shards' words fixed) holds every K20-K22, K5, K7 and K8 launch against
   its plain version (the RMAT slices at three knob sets: every hub
   branch, K21's recording variant), and K21/K22 run on 200 random
   control blocks, carries, rings and live tables. A ``sharded-bucketed``
   telemetry run launches K21's recording variant alone, with the same
   coloring. Then ``python -m dgc_tpu_torch`` at two ranks on cuda:0
   (gloo; children started as ``torchrun`` starts them), 100k vertices,
   both backends: each rank's coloring JSON equal to the world-size-1
   run's. Then the ring-halo engine, ``sharded-ring``, through the CLI's
   calls at world size 1 under NCCL: the flat rotation tables on the 1M
   uniform draw, the bucketed ones on the 1M RMAT draw; the launch counts
   must show K23, K25, K21 and K22 (and K24 on RMAT), and the coloring
   JSON and the attempts must be ``ell``'s (``ell-bucketed``'s); one
   more sweep with every K23 launch held, then profiled (``k23_sweep_ms``
   beside the bound over the same launches); K23-K25 timed on a
   mid-attempt superstep. Two supersteps from seeded words as shard 3 of
   4 of each
   draw's rotation tables (the other shards' words fixed), at a one-plane
   window and the engine's, at the main path's budget and at 12, hold
   every K23, K24, K25 and K21 launch against its plain version, and
   K23-K25 run on 120 random blocks, narrow layouts (a flat table, or one
   to three buckets of widths 1 to 1,500 over row lists with padding
   rows) and accumulators, K23 50 times more on one input and once on a
   65,536-wide row of 40,000 real entries. A ``sharded-ring`` telemetry run
   launches K21's recording variant alone, with the same coloring. Then
   three gloo ranks on cuda:0 (the only run where the ring sends: its
   rotations staged through host buffers), 100k vertices, ``sharded`` and
   ``sharded-ring``: each rank's coloring JSON equal to the world-size-1
   run's, each rank's peak memory and a rotation's host time recorded.
   Then the telemetry runs: ``cli.main``
   with ``--log-json --run-manifest --metrics-prom --superstep-timing``
   on 1M uniform jump, 1M RMAT jump, 1M uniform strict at
   ``--attempts-per-dispatch 4`` and 1M uniform ``ell-bucketed``, each
   against one run with ``--log-json`` alone: the launch counts,
   zeroed just before each run and read just after, must show the
   recording kernels of the path and not the ones they replace (and the
   reverse with telemetry off); the coloring JSON and the attempts must
   be the same, the host syncs too, and the bytes copied home larger by
   the trajectory buffers alone; the three files parse under the port's
   schema copy, every attempt's trajectory spans it, a SUCCESS ends with
   no active row, a FAILURE's last row fails, ``step_us`` is −1 first
   and non-negative after, and ``dgc_device_dispatches_total`` counts
   the engine calls (a block once). Then the
   dense backend through the CLI's calls at its cap, 16,384 vertices
   (``--max-degree 32 --seed 0``, uniform and RMAT, kmax 128 and 2,432):
   both kernels must launch, the sweep held call by call against the
   plain versions on the card's tensors must give the same attempts and
   colors (some K12 call giving a warp a row, some a whole block),
   K11 and K12 are timed per superstep over the k0 attempt
   beside their bounds, plain versions and (K11) ``torch.matmul`` (device
   time, as the kernels');
   ``oracle`` and ``reference-sim`` run on the same graphs; and
   ``python -m dgc_tpu_torch`` with the RMAT flags on the card writes the
   coloring JSON its ``--device cpu`` run (a child process) wrote.
   Then the serve tier: ``python -m dgc_tpu_torch serve``'s
   ``serve_main`` on a stream of 44 requests (32 uniform 20k-vertex
   graphs, class v32768w32; 8 uniform 100k-vertex native draws, class
   v131072w32; 4 RMAT 20k-vertex graphs past the widest class, served
   by the single-graph fallback on ``ell-compact``), continuous and sync
   at ``--batch-max`` 8 and 32, and continuous at 32 with
   ``--kernel-timing --log-json --run-manifest --metrics-prom``: every
   request's status, colors, attempt tuples, ``batched`` and
   ``shape_class`` must equal the single-graph ``find_minimal_coloring``
   on the card (the sequential loop, timed beside), with no fallback
   rung or retry and K13-K16 launched (zeroed just before each run, read
   just after); then K13-K16 held against their plain versions and
   profiled over one 32-lane sweep of the serving class (and an armed
   sweep, half its lanes spec-tagged) and one 8-lane sweep of the 100k
   requests' class (K13 without a staged lane state), each K13 launch's
   path read from its plan. A sixth replay (continuous, batch 8) and two
   drawn-once runs
   (continuous, batch 8 and 32) run with
   ``--device-carry``: equal to the same loop, K17-K19 launched there and
   nowhere else. Then speculative minimal-k on a 500,000-vertex uniform
   native draw (class v524288w32) from k0 = 33, strict, four ways: the
   plain ``ell-compact`` CLI, the serve pool's sequential arm
   (``ServeSequentialMinimalKEngine``), ``--speculate-k 3`` and
   ``--speculate-k auto``: the coloring JSON and attempt tuples equal
   across them, the speculative arms launching K13-K17 and the armed
   K15/K16; and K17-K19 held and timed at the serving class
   (``measure_carry``). Then the lane mesh (``phase_mesh_main``): the
   drawn-once stream through the front end over 2 and 4 lane slots on
   cuda:0 (``lane_mesh_over``), continuous with and without the device
   carry, sync at 2, beside the unsharded run: every request equal to the
   single-graph loop's, the partial K15/K16 launched and folding on every
   mesh run (no standalone K26), the mesh K18/K19 on the device-carry
   ones; a device loss at
   4 slots (the ``mesh`` fault point) degrading to 2, and a restore to 4;
   at the serving class (``measure_mesh``) the 8 uniform 20k requests of
   a batch swept over 4 slots of 2 lanes (in the main path's priced
   slices, the clock off and on, and in slices of 7 that the budget cuts)
   and over 2 slots of 4 (whole, as sync mode runs it), every partial
   K16/K15, K13 and K14 launch held exact against its plain version, each
   fold in the last shard's tail against the plain fold of the partial
   words the shards just wrote; the fold's cost in the tail and the mesh
   K18/K19 timed there.
4. The long strict chain: a 3,000-vertex RMAT graph (seed 1, average
   degree 16) from k = 465, about 450 attempts, and its jump sweep,
   blocked on the card at 2 and 4 a block against the CPU sequential
   runs (computed in a child process on one core while phases 1-3 run);
   the strict chain killed at a block boundary and resumed from its
   checkpoint on the card must equal the uninterrupted one.
5. Only with ``--mesh-cards`` (and then alone): the lane mesh with one
   slot on each card of the host (``phase_mesh_cards``): peer access,
   the folding tail reaching the other cards' control blocks, the events
   ordering each
   round and each resize's gathers. The held sweeps of phase 3 with shard
   i on card i mod the count, then the drawn-once stream over every card
   (continuous with and without the device carry, and sync) beside the
   unsharded run, every request equal to the single-graph loop's.

Output: one JSON line per phase and per phase-3 run, the script's total
seconds (``{"phase": "total"}``), the card's name and
power limit as ``nvidia-smi`` gives them, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is present or the port is missing. Imports no JAX and nothing
of ``dgc_tpu``.
"""

from __future__ import annotations

import argparse
import filecmp
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SMOKE_V = 20_000
MAIN_ARGS = ["--node-count", "1000000", "--max-degree", "32",
             "--gen-method", "fast", "--seed", "0", "--device", "cuda"]
# the 1M paths' backends, by name (BACKENDS also holds dense and the host
# engines, which the 1M graphs are not for)
ELL_BACKENDS = ("ell-compact", "ell-bucketed", "ell")
# the heavy-tail main path: RMAT of average degree 16, no degree cap
RMAT_ARGS = ["--node-count", "1000000", "--max-degree", "32",
             "--gen-method", "rmat", "--seed", "0", "--device", "cuda"]


# sha256 of the 1M main-path draws (``graph_sha256``): the C++ generators
# of ``dgc_tpu_torch.native``, the same graphs ``dgc_tpu.cli`` draws at
# these flags (uniform: 15,999,324 directed edges; RMAT: Δ 38,142)
DRAW_SHA256 = {
    "fast": "1c2e21ab7a90f850e863f810e3907e7cbd697d5e513a9a62d17dc1e1a0fc3e9f",
    "rmat": "35f35683fdfe8e6820c54d25e10f6da2b0a969befdbec097913c2b7979500f16",
}


def graph_sha256(arrays) -> str:
    """sha256 of a graph's CSR: ``indptr`` then ``indices``, int32 LE."""
    return hashlib.sha256(arrays.indptr.astype("<i4").tobytes()
                          + arrays.indices.astype("<i4").tobytes()).hexdigest()


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def card_lines() -> str:
    """Every card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def card_line() -> str:
    return card_lines().splitlines()[0]


# ---- phase 1: kernels vs plain ----------------------------------------------

def _random_case(rng, planes: int, k: int, capped: bool, cur: int, device):
    from dgc_tpu_torch.engine.bucketed import fail_valid
    from dgc_tpu_torch.kernels.superstep import CTRL_CUR, new_ctrl, new_state

    v, rows = 3000, 700
    width = 32 * planes + 16 if capped else 32 * planes - 1
    colors = rng.integers(0, 32 * planes + 40, size=v)
    packed = np.where(rng.random(v) < 0.3, -1,
                      colors * 2 + rng.integers(0, 2, size=v)).astype(np.int32)
    state = new_state(torch.from_numpy(packed).to(device))
    state[1, :v] = torch.from_numpy(rng.permutation(packed)).to(device)
    nbrs = rng.integers(0, v + 1, size=(rows, width))
    nbrs[rng.random(rows) < 0.05] = v  # rows full of pad sentinels
    beats = rng.integers(0, 2, size=(rows, width))
    table = torch.from_numpy((nbrs | beats << 30).astype(np.int32)).to(device)
    ctrl = new_ctrl(step=3, prev_active=v, device=device)
    ctrl[CTRL_CUR] = cur
    row0 = int(rng.integers(0, v - rows + 1))
    return ctrl, state, table, row0, fail_valid(width, planes, k)


def phase_kernels(device) -> int:
    """K1 and K2 vs their plain versions; returns the max abs difference."""
    from dgc_tpu_torch.kernels import superstep as ks

    rng = np.random.default_rng(0)
    err = 0
    cases = 0
    for planes in (1, 2, 3, 32, 40):  # 40: a widened window, two groups
        for k in (1, 31, 32, 33, 32 * planes, 32 * planes + 7):
            for capped in (False, True):
                cur = cases % 2
                ctrl, state, table, row0, fv = _random_case(
                    rng, planes, k, capped, cur, device)
                ctrl_p, state_p = ctrl.clone(), state.clone()
                plan = ks.row_plan(table, state.shape[1] - 1)
                ks.superstep_rows(ctrl, state, table, row0, planes, k, fv,
                                  plan)
                ks.superstep_rows_reference(ctrl_p, state_p, table, row0,
                                            planes, k, fv, plan)
                err = max(err, int((state - state_p).abs().max()),
                          int((ctrl - ctrl_p).abs().max()))
                cases += 1
    # an attempt that already left RUNNING: K1 must touch nothing
    ctrl, state, table, row0, fv = _random_case(rng, 2, 40, False, 0, device)
    ctrl[ks.CTRL_STATUS] = 1
    before = (ctrl.clone(), state.clone())
    ks.superstep_rows(ctrl, state, table, row0, 2, 40, fv,
                      ks.row_plan(table, state.shape[1] - 1))
    err = max(err, int((state - before[1]).abs().max()),
              int((ctrl - before[0]).abs().max()))
    err = max(err, _k1_team_cases(ks, rng, device))
    # K2 over random loop carries and both stall rules
    for _ in range(300):
        status = int(rng.choice([0, 0, 0, 1, 2, 3]))
        step = int(rng.integers(0, 100))
        prev = int(rng.integers(0, 50))
        fail = int(rng.choice([0, 0, int(rng.integers(1, 5))]))
        active = int(rng.choice([0, prev, int(rng.integers(0, 60))]))
        vals = [status, step, prev, int(rng.integers(0, 70)),
                int(rng.integers(0, 2)), fail, active, int(rng.integers(-1, 9))]
        ctrl = torch.tensor(vals, dtype=torch.int32, device=device)
        ctrl_p = ctrl.clone()
        max_steps = int(rng.choice([ks.INT32_MAX, int(rng.integers(1, 110))]))
        window = int(rng.choice([64, ks.INT32_MAX, int(rng.integers(1, 70))]))
        ks.superstep_finish(ctrl, max_steps, window)
        ks.superstep_finish_reference(ctrl_p, max_steps, window)
        err = max(err, int((ctrl - ctrl_p).abs().max()))
    torch.cuda.synchronize()
    check(err == 0, f"kernels disagree with their plain versions: max abs "
                    f"err {err}")
    return err


# K1's team cases (width, rows): a lane (1-32 wide), 2-32 lanes, a warp
# (1,025-4,095), a block (from 4,096), and one 65,536-wide row of 40,000
# real entries (the 1M RMAT draw's hub bucket holds one of 38,142)
K1_WIDTHS = ((1, 600), (4, 600), (32, 600), (33, 400), (64, 300),
             (256, 200), (1024, 120), (1025, 60), (4095, 40), (4096, 24),
             (8192, 12), (65536, 1))


def _k1_case(rng, rows: int, width: int, planes: int, device,
             confirmed: float = 0.3):
    """K1's inputs over a 5,000-vertex state: ``rows`` ragged rows of
    ``width`` (real lengths from none to the whole width, the pad sentinel
    past them, a row of 40,000 real entries at 65,536), words uncolored,
    fresh and ``confirmed``, colors mostly low (one pass of planes reads
    the row) and some past the window; either buffer current."""
    v = 5000
    real = (np.full(rows, 40_000) if width == 65536
            else rng.integers(0, width + 1, rows))
    table = torch.from_numpy(_ragged(rng, rows, width, v, real)).to(device)
    cols = np.where(rng.random(v) < 0.8, rng.integers(0, 8, v),
                    rng.integers(0, 32 * planes + 40, v))
    kind = rng.random(v)
    words = np.where(kind < 0.2, -1, np.where(kind < 1 - confirmed,
                                              cols * 2 + 1, cols * 2))
    state = torch.full((2, v + 1), -1, dtype=torch.int32, device=device)
    state[0, :v] = torch.from_numpy(words.astype(np.int32)).to(device)
    state[1, :v] = torch.from_numpy(
        rng.permutation(words).astype(np.int32)).to(device)
    row0 = int(rng.integers(0, v - rows + 1))
    return table, state, row0


def _k1_team_cases(ks, rng, device) -> int:
    """K1 against its plain version in every team mode (``K1_WIDTHS``),
    at 1, 2, 3, 32, 33 and 40 planes, budgets 1 to past the window, both
    fail gates, either buffer current; then ``REPLAYS`` launches of a lane
    and a block case on one input, each equal to the plain version's
    bytes. Returns the max abs difference."""
    err = 0
    for width, rows in K1_WIDTHS:
        for planes in ((1, 2, 32, 40) if width <= 64 else (3, 32, 33)):
            table, state, row0 = _k1_case(rng, rows, width, planes, device)
            plan = ks.row_plan(table, state.shape[1] - 1)
            for k in (1, 32, 33, 64, 32 * planes, 32 * planes + 7):
                for fv in (False, True):
                    ctrl = ks.new_ctrl(3, 5000, device)
                    ctrl[ks.CTRL_CUR] = int(rng.integers(0, 2))
                    s_k, c_k = state.clone(), ctrl.clone()
                    s_p, c_p = state.clone(), ctrl.clone()
                    ks.superstep_rows(c_k, s_k, table, row0, planes, k, fv,
                                      plan)
                    ks.superstep_rows_reference(c_p, s_p, table, row0,
                                                planes, k, fv, plan)
                    err = max(err, _diff(s_k, s_p), _diff(c_k, c_p))
    for width, rows in ((32, 600), (65536, 1)):
        table, state, row0 = _k1_case(rng, rows, width, 32, device, 0.0)
        plan = ks.row_plan(table, state.shape[1] - 1)
        ctrl = ks.new_ctrl(3, 5000, device)
        s_p, c_p = state.clone(), ctrl.clone()
        ks.superstep_rows_reference(c_p, s_p, table, row0, 32, 1000, True,
                                    plan)
        for _ in range(REPLAYS):
            s_k, c_k = state.clone(), ctrl.clone()
            ks.superstep_rows(c_k, s_k, table, row0, 32, 1000, True, plan)
            err = max(err, _diff(s_k, s_p), _diff(c_k, c_p))
    torch.cuda.synchronize()
    return err


def _diff(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return 1 << 40
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def _packed_words(rng, n: int, max_color: int, active: float) -> np.ndarray:
    """Packed words: uncolored (−1) or fresh at rate ``active``, the rest
    confirmed, colors below ``max_color``."""
    col = rng.integers(0, max_color, size=n)
    act = rng.random(n) < active
    words = np.where(act, np.where(rng.random(n) < 0.5, -1, col * 2 + 1),
                     col * 2)
    return words.astype(np.int32)


def _compact_state(rng, v: int, max_color: int, active: float, device):
    """int32[2, V+2] buffers holding different words, the sentinel −1 at V
    and the dummy row 0 at V+1 in both."""
    state = np.stack([_packed_words(rng, v + 2, max_color, active)
                      for _ in range(2)])
    state[:, v], state[:, v + 1] = -1, 0
    return torch.from_numpy(state).to(device)


def _combined(rng, shape, v: int, sentinel_rate: float = 0.15) -> np.ndarray:
    nb = rng.integers(0, v + 1, size=shape)
    nb[rng.random(shape) < sentinel_rate] = v
    return (nb | (rng.integers(0, 2, size=shape) << 30)).astype(np.int32)


# stage width ranges (start, stop, width, planes): the 4096-vertex RMAT
# layout's (planes 33 and 17) and a one-range stage
K4_RANGES = (((0, 1, 1040, 33), (1, 14, 512, 17), (14, 94, 128, 5),
              (94, 345, 44, 2), (345, 745, 16, 1), (745, 1024, 8, 1)),
             ((0, 64, 16, 1),))
# full-table parts (sizes, widths, planes): windows covering their widths,
# and the same with capped windows (fail gate off unless k fits)
K5_PARTS = (((40, 300, 900, 2000), (1040, 40, 12, 4), (33, 2, 1, 1)),
            ((40, 300, 900, 2000), (1100, 80, 12, 4), (32, 1, 1, 1)))


# K3's edge cases (V, density, pads, (cur, row0) pairs): V one below, at
# and one above K3's round of 2,048 items (512 threads of four), and V + 2
# (the buffers' stride) at each residue mod 4, so the other buffer takes
# 16-, 8- and 4-byte stores; more rounds than one wave of blocks (2 on each
# of 132 SMs) at 1.5M; a first-stage-like pad far above the count (the
# 1M draw's 262,144 over a few thousand actives); row offsets that move the
# first chunk's alignment
K3_EDGES = (
    (2047, 0.3, (1, 1000, 2048, 4096), ((0, 0), (1, 0), (1, 1))),
    (2048, 0.5, (1, 1024, 2048), ((0, 0), (1, 3), (0, 2047))),
    (2049, 0.3, (700, 2049, 3000), ((0, 0), (1, 2), (0, 2048))),
    (4098, 1.0, (4098, 4096, 5000), ((1, 0), (0, 5))),
    (1_500_000, 0.3, (1 << 19, 1 << 21), ((0, 0), (1, 999_999))),
    (1_000_000, 0.004, (262_144,), ((0, 0), (1, 0), (0, 3), (1, 250_001))),
)


def _k3_cases(kc, rng, device) -> int:
    """K3 against its plain version over seeded states: 5,000 vertices at
    densities from none to all and pads below, at and above the count, and
    ``K3_EDGES``; every launch on one scratch. Returns the max abs
    difference (idx, both buffers, ctrl)."""
    scratch = kc.new_slots_scratch(device)
    err = 0
    cases = [(5000, density, (1, 64, 1500, 8192), ((0, 0), (1, 0), (1, 37)))
             for density in (0.0, 0.01, 0.3, 1.0)] + list(K3_EDGES)
    for v, density, pads, offsets in cases:
        for pad in pads:
            for cur, row0 in offsets:
                state = _compact_state(rng, v, 200, density, device)
                ctrl = kc.new_ctrl(3, v, device)
                ctrl[kc.CTRL_CUR] = cur
                s_p, c_p = state.clone(), ctrl.clone()
                idx = kc.compact_slots(ctrl, state, row0, pad, scratch)
                idx_p = kc.compact_slots_reference(c_p, s_p, row0, pad)
                err = max(err, _diff(idx, idx_p), _diff(state, s_p),
                          _diff(ctrl, c_p))
    return err


def phase_compact_kernels(device) -> int:
    """K3-K6 vs their plain versions on seeded random cases; returns the
    max abs difference."""
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.ops.segmented_gather import (plan_from_parts,
                                                    plan_from_ranges)

    rng = np.random.default_rng(1)
    v = 5000
    err = _k3_cases(kc, rng, device)
    # K4 and K5 over slot lists: the stage layouts of K4_RANGES
    flat_ext = torch.from_numpy(np.concatenate([
        _combined(rng, (v, 1040), v),
        np.full((1, 1040), v, np.int32)])).to(device)
    budgets = (1, 31, 32, 33, 1056, 5000)
    for ranges in K4_RANGES:
        plan = plan_from_ranges(ranges)
        desc = kc.plan_desc(plan, device)
        pad = ranges[-1][1]
        for density in (0.05, 0.5):
            act = torch.from_numpy(rng.random(v) < density).to(device)
            idx = kc.compact_idx(act, pad, v)
            seg, gidx = kc.stage_rows(flat_ext, idx, plan, desc, 0, v)
            seg_p, gidx_p = kc.stage_rows_reference(flat_ext, idx, plan, 0, v)
            err = max(err, _diff(seg, seg_p), _diff(gidx, gidx_p))
            for k in budgets:
                err = max(err, _k5_case(kc, rng, v, seg, plan, desc, k,
                                        device, gidx=gidx))
    # K5 over row spans: covering and capped windows, a row offset
    for sizes, widths, planes in K5_PARTS:
        plan = plan_from_parts(sizes, widths, planes)
        desc = kc.plan_desc(plan, device)
        seg = torch.from_numpy(_combined(
            rng, sum(s * w for s, w in zip(sizes, widths)), v)).to(device)
        for k in budgets:
            for row_base in (0, 1000):
                err = max(err, _k5_case(kc, rng, v, seg, plan, desc, k, device,
                                        row_base=row_base))
    # K5 at every flat width, ragged rows, spans and slot lists, and its
    # replays
    for plan, seg, gidx, row_base in _k5_width_cases(rng, v, device):
        desc = kc.plan_desc(plan, device)
        for k in (1, 33, 300):
            err = max(err, _k5_case(kc, rng, v, seg, plan, desc, k, device,
                                    gidx=gidx, row_base=row_base))
    err = max(err, _k5_replays(kc, rng, v, device))
    # K6 over random loop carries: pushes, failures, stalls, idle stages,
    # with and without a hub region's live table
    for _ in range(300):
        state = _compact_state(rng, v, 200, 0.3, device)
        nh = int(rng.integers(0, 8))
        nb = nh + (1 if nh == 0 else int(rng.integers(0, 2)))

        def rand(*shape):
            return torch.from_numpy(rng.integers(-1, 99, shape)
                                    .astype(np.int32)).to(device)

        ring = (rand(kc.REC_SLOTS, v + 2), rand(kc.REC_SLOTS, nb),
                rand(kc.REC_SLOTS, kc.META_COLS))
        live = rand(kc.LIVE_ROWS, nb)
        prev = int(rng.integers(0, 50))
        vals = [int(rng.choice([0, 0, 0, 1, 2])), int(rng.integers(0, 100)),
                prev, int(rng.integers(0, 70)), int(rng.integers(0, 2)),
                int(rng.choice([0, 0, int(rng.integers(1, 5))])),
                int(rng.choice([0, prev, int(rng.integers(0, 60))])),
                int(rng.integers(-1, 40)), int(rng.integers(0, 9)),
                int(rng.integers(-1, 40)), 0]
        ctrl = torch.tensor(vals, dtype=torch.int32, device=device)
        record = bool(rng.integers(0, 2))
        thresh = int(rng.choice([0, 0, int(rng.integers(0, 60))]))
        max_steps = int(rng.choice([kc.INT32_MAX, int(rng.integers(1, 110))]))
        window = int(rng.choice([64, int(rng.integers(1, 70))]))
        c_p, s_p, l_p = ctrl.clone(), state.clone(), live.clone()
        r_p = tuple(t.clone() for t in ring)
        kc.stage_finish(ctrl, state, ring, live, nh, thresh, max_steps, window,
                        record)
        kc.stage_finish_reference(c_p, s_p, r_p, l_p, nh, thresh, max_steps,
                                  window, record)
        err = max(err, _diff(ctrl, c_p), _diff(state, s_p), _diff(live, l_p),
                  *(_diff(a, b) for a, b in zip(ring, r_p)))
    torch.cuda.synchronize()
    check(err == 0, f"K3-K6 disagree with their plain versions: max abs "
                    f"err {err}")
    return err


def _k5_case(kc, rng, v, seg, plan, desc, k, device, gidx=None,
             row_base=0) -> int:
    """K5 against its plain version from a random state, live and in each
    of the three ways a stage is no longer live."""
    err = 0
    for status, prev, step in ((0, v, 3), (1, v, 3), (0, 10, 3), (0, v, 99)):
        state = _compact_state(rng, v, 32 * max(s.planes for s in plan) + 40,
                               0.4, device)
        ctrl = kc.new_ctrl(step, prev, device)
        ctrl[kc.CTRL_STATUS] = status
        ctrl[kc.CTRL_CUR] = int(rng.integers(0, 2))
        ctrl[kc.CTRL_MC] = int(rng.integers(-1, 5))
        s_p, c_p = state.clone(), ctrl.clone()
        kc.segmented_superstep(ctrl, state, seg, plan, desc, k, 10, 50,
                               gidx=gidx, row_base=row_base)
        kc.segmented_superstep_reference(c_p, s_p, seg, plan, k, 10, 50,
                                         gidx=gidx, row_base=row_base)
        err = max(err, _diff(state, s_p), _diff(ctrl, c_p))
    return err


def _ragged(rng, rows: int, width: int, v: int, real=None) -> np.ndarray:
    """A combined table of ``rows`` rows whose real lengths are ``real``
    (default: random from none to the whole width): ``_combined`` entries
    (pad sentinels among them too) up to each row's length, the pad
    sentinel ``v`` past it."""
    t = _combined(rng, (rows, width), v)
    if real is None:
        real = rng.integers(0, width + 1, rows)
    t[np.arange(width)[None, :] >= np.asarray(real)[:, None]] = v
    return t


FLAT_CAP = 256  # the compact engine's flat cap (DEFAULT_FLAT_CAP)


def _k5_width_cases(rng, v: int, device) -> list:
    """K5's cases at every flat width from 1 to ``FLAT_CAP`` (each width
    its lanes a row): plans of up to 64 one-width segments of ragged rows,
    windows covering their widths and capped at one plane, over row spans
    and over slot lists with dummy slots."""
    from dgc_tpu_torch.ops.bitmask import num_planes_for
    from dgc_tpu_torch.ops.segmented_gather import plan_from_parts

    cases = []
    for w0 in range(1, FLAT_CAP + 1, 64):
        widths = list(range(w0, min(w0 + 64, FLAT_CAP + 1)))
        sizes = [int(rng.integers(1, 6)) for _ in widths]
        seg = torch.from_numpy(np.concatenate([
            _ragged(rng, n, w, v).reshape(-1) for n, w in zip(sizes, widths)
        ])).to(device)
        rows = sum(sizes)
        gidx = rng.choice(v, size=rows, replace=False).astype(np.int32)
        gidx[rng.random(rows) < 0.1] = v + 1
        gidx = torch.from_numpy(gidx).to(device)
        for capped in (False, True):
            planes = [1 if capped else num_planes_for(w + 1) for w in widths]
            plan = plan_from_parts(sizes, widths, planes)
            cases += [(plan, seg, None, 0), (plan, seg, None, 1000),
                      (plan, seg, gidx, 0)]
    return cases


# launches of K5, K8, K13 and K15 on one input, each equal to the first
REPLAYS = 50


def _k5_replays(kc, rng, v: int, device, rec: bool = False) -> int:
    """K5 (its recording variant with ``rec``) launched ``REPLAYS`` times
    from the same inputs, a 256-wide segment among them: its shared-word
    ORs must give the same bytes each time, the plain version's."""
    from dgc_tpu_torch.ops.segmented_gather import plan_from_parts

    plan = plan_from_parts((40, 300, 900), (256, 40, 12), (9, 2, 1))
    seg = torch.from_numpy(np.concatenate([
        _ragged(rng, s_.rows, s_.width, v).reshape(-1) for s_ in plan])
    ).to(device)
    desc = kc.plan_desc(plan, device)
    state = _compact_state(rng, v, 300, 0.4, device)
    ctrl = kc.new_ctrl(3, v, device)
    umax = torch.zeros(2, dtype=torch.int32, device=device) if rec else None
    s_p, c_p = state.clone(), ctrl.clone()
    u_p = None if umax is None else umax.clone()
    kc.segmented_superstep_reference(c_p, s_p, seg, plan, 300, 10, 50,
                                     umax=u_p, ucol=1)
    err = 0
    for _ in range(REPLAYS):
        s_k, c_k = state.clone(), ctrl.clone()
        u_k = None if umax is None else umax.clone()
        kc.segmented_superstep(c_k, s_k, seg, plan, desc, 300, 10, 50,
                               umax=u_k, ucol=1)
        err = max(err, _diff(s_k, s_p), _diff(c_k, c_p),
                  0 if u_k is None else _diff(u_k, u_p))
    return err


# hub buckets (rows, width, ladder): None is the hub_pad_for ladder (a
# compaction pad of 64 at 300 rows, none at 40), a tuple a prune config
# (P, U) or (P, U, P2); P = rows drops the full branch
HUB_BUCKETS = ((1, 2048, "uncond"), (300, 64, None), (20, 1024, (20, 256)),
               (190, 512, (128, 128, 32)), (100, 256, (64, 64)),
               (40, 512, None))


def _hub_pool(rng, plan, pool, device) -> None:
    """Captures as a rebase and a shrink leave them: per tier, ordered
    distinct slots padded with the dummy row, neighbor lists and planes."""
    v = 5000
    for b in plan.buckets:
        if not b.u:
            continue
        for slots, comb, conf, n in ((b.slots1, b.comb1, b.conf1, b.pad),
                                     (b.slots2, b.comb2, b.conf2, b.p2)):
            if not n:
                continue
            m = int(rng.integers(0, n + 1))
            chosen = np.sort(rng.choice(b.rows, size=min(m, b.rows),
                                        replace=False))
            words = np.full(n, b.rows, np.int64)
            words[: len(chosen)] = chosen
            pool[slots: slots + n] = torch.from_numpy(words).to(device)
            pool[comb: comb + n * b.u] = torch.from_numpy(
                _combined(rng, n * b.u, v, 0.4)).to(device)
            pool[conf: conf + n * b.planes] = torch.from_numpy(
                rng.integers(-2**31, 2**31, n * b.planes).astype(np.int32)
            ).to(device)


def phase_hub_kernels(device) -> int:
    """K7 and K8 vs their plain versions on seeded random hub regions:
    every ladder and branch (each reached, checked), pads below, at and
    above the live count, rebases whose capture holds and fails, tier 1 to
    2, 1- and 32-plane windows and mixed ones, budgets 1 to past the
    window, dummy slots, either buffer current, and stages that are not
    live. Returns the max abs difference."""
    from dgc_tpu_torch.engine import hub as th
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.kernels import hub as kh

    rng = np.random.default_rng(2)
    v = 5000
    sizes = [b[0] for b in HUB_BUCKETS]
    widths = [b[1] for b in HUB_BUCKETS]
    prune = tuple(b[2] if isinstance(b[2], tuple) else None
                  for b in HUB_BUCKETS)
    uncond = tuple(b[2] == "uncond" for b in HUB_BUCKETS)
    row0s = np.concatenate([[0], np.cumsum(sizes[:-1])]) + 37
    table = torch.from_numpy(_combined(
        rng, sum(r * w for r, w in zip(sizes, widths)), v)).to(device)
    err = 0
    branches, oks = set(), set()
    for trial in range(72):
        planes = ((1,) * 6 if trial % 3 == 0 else (32,) * 6 if trial % 3 == 1
                  else tuple(int(p) for p in rng.choice([1, 2, 3, 32], 6)))
        plan = kh.hub_plan(row0s, sizes, widths, planes, prune, uncond,
                           device, table=table, v=v)
        pool = kh.new_pool(plan, device)
        _hub_pool(rng, plan, pool, device)
        nb = len(sizes) + 1
        live = torch.from_numpy(rng.integers(-5, 50, (kc.LIVE_ROWS, nb))
                                .astype(np.int32)).to(device)
        for bi, b in enumerate(plan.buckets):
            cuts = [0, 1, b.pad, b.pad + 1, b.rows, b.p2, b.p2 + 1]
            live[kc.LIVE_BA, bi] = int(rng.choice([c for c in cuts
                                                   if 0 <= c <= b.rows]))
            live[kc.LIVE_TIER, bi] = int(rng.integers(0, 3 if b.p2 else
                                                      2 if b.u else 1))
        state = _compact_state(rng, v, 32 * max(planes) + 40,
                               float(rng.choice([0.02, 0.3, 1.0])), device)
        ctrl = kc.new_ctrl(3, v, device)
        ctrl[kc.CTRL_CUR] = trial % 2
        ctrl[kc.CTRL_MC] = int(rng.integers(-1, 5))
        if trial % 9 == 8:  # a stage that is not live: nothing may move
            ctrl[[kc.CTRL_STATUS, kc.CTRL_PREV_ACTIVE, kc.CTRL_STEP][
                trial % 27 // 9]] = [1, 10, 99][trial % 27 // 9]
        k = int(rng.choice([1, 31, 33, 32 * max(planes), 32 * max(planes) + 7,
                            v]))
        c_p, s_p, l_p, p_p = (t.clone() for t in (ctrl, state, live, pool))
        kh.hub_slots(ctrl, state, live, plan, pool, 10, 50)
        kh.hub_slots_reference(c_p, s_p, l_p, plan, p_p, 10, 50)
        err = max(err, _diff(ctrl, c_p), _diff(state, s_p), _diff(live, l_p),
                  _diff(pool, p_p))
        if kc.stage_live(ctrl.tolist(), 10, 50):
            branches |= set(l_p[kc.LIVE_BRANCH, :len(sizes)].tolist())
        kh.hub_superstep(ctrl, state, table, live, plan, pool, k, 10, 50)
        kh.hub_superstep_reference(c_p, s_p, table, l_p, plan, p_p, k, 10, 50)
        err = max(err, _diff(ctrl, c_p), _diff(state, s_p), _diff(live, l_p),
                  _diff(pool, p_p))
        for bi in range(len(sizes)):
            if int(l_p[kc.LIVE_BRANCH, bi]) == th.BRANCH_REBASE:
                oks.add(int(l_p[kc.LIVE_TIER_NEXT, bi]))
    torch.cuda.synchronize()
    check(branches == set(range(len(th.BRANCH_NAMES))),
          f"phase 1 reached only the hub branches {sorted(branches)}")
    check(oks == {0, 1}, f"rebase captures held only as {sorted(oks)}")
    err = max(err, _k8_wide_cases(rng, device))
    check(err == 0, f"K7/K8 disagree with their plain versions: max abs "
                    f"err {err}")
    return err


def _wide_hub_region(kh, rng, device):
    """Hub buckets (rows, width, ladder, pad) from half K8's block width to
    eight times it, and a 65,536-wide row of 40,000 real entries, every
    ladder among them (pads given, so a dozen rows compact), with ragged
    real lengths; returns (v, row0s, sizes, widths, prune, uncond, pads,
    table)."""
    bw = kh.K8_BLOCK_WIDTH
    buckets = ((1, 65536, "uncond", 0), (6, 4 * bw, (4, bw, 2), 0),
               (12, 2 * bw, None, 4), (8, bw, (4, bw // 4), 0),
               (20, bw // 2, (8, bw // 8, 4), 0), (3, 8 * bw, "uncond", 0))
    v = 60_000
    sizes = [b[0] for b in buckets]
    widths = [b[1] for b in buckets]
    prune = tuple(b[2] if isinstance(b[2], tuple) else None for b in buckets)
    uncond = tuple(b[2] == "uncond" for b in buckets)
    pads = [b[3] for b in buckets]
    row0s = np.concatenate([[0], np.cumsum(sizes[:-1])]) + 101
    parts = []
    for n, w in zip(sizes, widths):
        real = ([40_000] if w == 65536 else
                rng.integers(w // 2, w + 1, n).tolist())
        real[0] = w if n > 1 else real[0]  # a full row where there are two
        parts.append(_ragged(rng, n, w, v, real).reshape(-1))
    table = torch.from_numpy(np.concatenate(parts)).to(device)
    return v, row0s, sizes, widths, prune, uncond, pads, table


def _k8_wide_cases(rng, device, rec: bool = False) -> int:
    """K7 and K8 (its recording variant with ``rec``) against their plain
    versions on ``_wide_hub_region``, items a warp and a block: each branch
    reached, windows of 1 to 64 planes (two passes),
    budgets in and past the window; then ``REPLAYS`` launches of K8 from one
    input, each equal to the first. Returns the max abs difference."""
    from dgc_tpu_torch.engine import hub as th
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.kernels import hub as kh

    v, row0s, sizes, widths, prune, uncond, pads, table = \
        _wide_hub_region(kh, rng, device)
    nb = len(sizes) + 1
    err = 0
    replay = None
    branches = set()
    modes = set()
    for trial in range(60):
        if trial >= 12 and branches == set(range(len(th.BRANCH_NAMES))):
            break
        planes = tuple(int(p) for p in rng.choice(
            [1, 2, 3, 32, 33, 64], len(sizes)))
        plan = kh.hub_plan(row0s, sizes, widths, planes, prune, uncond,
                           device, pads=pads, table=table, v=v)
        modes |= {b.mode for b in plan.buckets}
        pool = kh.new_pool(plan, device)
        _hub_pool(rng, plan, pool, device)
        live = torch.from_numpy(rng.integers(-5, 50, (kc.LIVE_ROWS, nb))
                                .astype(np.int32)).to(device)
        for bi, b in enumerate(plan.buckets):
            cuts = [0, 1, b.pad, b.pad + 1, b.rows, b.p2, b.p2 + 1]
            live[kc.LIVE_BA, bi] = int(rng.choice(
                [c for c in cuts if 0 <= c <= b.rows]))
            live[kc.LIVE_TIER, bi] = int(rng.integers(
                0, 3 if b.p2 else 2 if b.u else 1))
        state = _compact_state(rng, v, 32 * max(planes) + 40,
                               float(rng.choice([0.05, 0.3, 1.0])),
                               device)
        ctrl = kc.new_ctrl(3, v, device)
        ctrl[kc.CTRL_CUR] = trial % 2
        ctrl[kc.CTRL_MC] = int(rng.integers(-1, 5))
        k = int(rng.choice([1, 33, 32 * max(planes),
                            32 * max(planes) + 7, v]))
        umax = (torch.from_numpy(rng.integers(0, 9, nb).astype(np.int32))
                .to(device) if rec else None)
        kh.hub_slots(ctrl, state, live, plan, pool, 10, 50)
        c_p, s_p, l_p, p_p = (t_.clone() for t_ in (ctrl, state, live,
                                                     pool))
        kh.hub_slots_reference(c_p, s_p, l_p, plan, p_p, 10, 50)
        err = max(err, _diff(ctrl, c_p), _diff(state, s_p),
                  _diff(live, l_p), _diff(pool, p_p))
        branches |= set(l_p[kc.LIVE_BRANCH, :len(sizes)].tolist())
        u_p = None if umax is None else umax.clone()
        if replay is None:
            replay = (plan, *(t_.clone() for t_ in (ctrl, state, live,
                                                    pool)), k, u_p)
        kh.hub_superstep(ctrl, state, table, live, plan, pool, k, 10, 50,
                         umax=umax)
        kh.hub_superstep_reference(c_p, s_p, table, l_p, plan, p_p, k,
                                   10, 50, umax=u_p)
        err = max(err, _diff(ctrl, c_p), _diff(state, s_p),
                  _diff(live, l_p), _diff(pool, p_p),
                  0 if umax is None else _diff(umax, u_p))
    check(branches == set(range(len(th.BRANCH_NAMES))),
          f"the wide hub rows reached only the branches {sorted(branches)}")
    check(modes == {kh.K8_WARP_ITEMS, kh.K8_BLOCK_ITEMS},
          f"K8's layout dealt the wide buckets only as {sorted(modes)}")
    # the replays: the 65,536-wide row uncolored, so its block walks it
    plan, ctrl, state, live, pool, k, umax = replay
    state[:, int(row0s[0])] = -1
    want = [t_.clone() for t_ in (ctrl, state, live, pool)] + (
        [] if umax is None else [umax.clone()])
    kh.hub_superstep_reference(want[0], want[1], table, want[2], plan,
                               want[3], k, 10, 50,
                               umax=want[4] if rec else None)
    for _ in range(REPLAYS):
        got = [t_.clone() for t_ in (ctrl, state, live, pool)] + (
            [] if umax is None else [umax.clone()])
        kh.hub_superstep(got[0], got[1], table, got[2], plan, got[3], k, 10,
                         50, umax=got[4] if rec else None)
        err = max(err, *(_diff(a, b) for a, b in zip(got, want)))
    torch.cuda.synchronize()
    return err


def _block_case(rng, v: int, nb: int, attempts: int, device):
    """A random block: state buffers, a control block (every status, a
    RUNNING one with and without work left), a block record open or done
    or full, a ring whose brackets hold the budget in no, one or several
    slots (a count above 4 too), degrees with isolated rows, a live table
    and the fresh live counts."""
    from dgc_tpu_torch.kernels import block as kb
    from dgc_tpu_torch.kernels import compact as kc

    state = _compact_state(rng, v, 200, 0.3, device)
    state[:, :v] = torch.from_numpy(np.where(
        rng.random((2, v)) < 0.2, -1,
        rng.integers(0, 2 * int(rng.choice([1, 40, 400])), (2, v)))
        .astype(np.int32)).to(device)
    k = int(rng.integers(1, 60))
    cnt = int(rng.choice([0, 1, 3, 4, 9]))
    meta = np.full((kc.REC_SLOTS, kc.META_COLS), -1, np.int64)
    for j in range(kc.REC_SLOTS):
        lo = int(rng.integers(-1, 70))
        meta[j] = (rng.integers(1, 90), lo, lo + int(rng.integers(1, 30)),
                   rng.integers(0, 60), rng.integers(0, v + 2))
        if rng.random() < 0.3:  # this slot's bracket holds k
            meta[j, 1], meta[j, 2] = k - int(rng.integers(1, 5)), \
                k + int(rng.integers(0, 5))
    ring = (torch.from_numpy(rng.integers(-1, 99, (kc.REC_SLOTS, v + 2))
                             .astype(np.int32)).to(device),
            torch.from_numpy(rng.integers(0, 99, (kc.REC_SLOTS, nb))
                             .astype(np.int32)).to(device),
            torch.from_numpy(meta.astype(np.int32)).to(device))
    prev = int(rng.choice([0, 0, int(rng.integers(1, v + 2))]))
    ctrl = torch.tensor([int(rng.choice([0, 0, 1, 2, 3])),
                         int(rng.integers(1, 99)), prev,
                         int(rng.integers(0, 60)), int(rng.integers(0, 2)),
                         int(rng.integers(0, 3)), int(rng.integers(0, 9)),
                         int(rng.integers(-1, 40)), cnt,
                         int(rng.integers(-1, 70)), 0],
                        dtype=torch.int32, device=device)
    blk = kb.new_block(k, attempts, ctrl[kc.CTRL_REC_CNT:
                                         kc.CTRL_REC_BEST + 1])[2].clone()
    n_att = int(rng.integers(0, attempts + 1))
    blk[kb.BLK_N_ATT] = n_att
    blk[kb.BLK_DONE] = int(rng.random() < 0.15)
    degrees = torch.from_numpy(np.where(rng.random(v) < 0.1, 0,
                                        rng.integers(1, 40, v))
                               .astype(np.int32)).to(device)
    live = torch.from_numpy(rng.integers(-5, 50, (kc.LIVE_ROWS, nb))
                            .astype(np.int32)).to(device)
    init_ba = torch.from_numpy(rng.integers(0, v, nb).astype(np.int32)
                               ).to(device)
    best = torch.from_numpy(rng.integers(-1, 9, v + 2).astype(np.int32)
                            ).to(device)
    return ctrl, state, blk, ring, degrees, live, init_ba, best


def phase_block_kernels(device) -> int:
    """K9 and K10 vs their plain versions on seeded random blocks (sizes
    from 1 vertex to past one grid's stride, 1 to 8 attempts, strict and
    jump, floors below, at and above the next budget); returns the max
    abs difference."""
    from dgc_tpu_torch.kernels import block as kb

    rng = np.random.default_rng(3)
    err = 0
    for trial in range(240):
        v = int(rng.choice([1, 7, 255, 256, 5000, 140_000]))
        nb = int(rng.choice([1, 1, 3, 8]))
        attempts = int(rng.choice([1, 2, 4, 8]))
        ctrl, state, blk, ring, degrees, live, init_ba, best = _block_case(
            rng, v, nb, attempts, device)
        k_min = int(rng.integers(-2, 70))
        strict = bool(trial % 2)
        held = [t.clone() for t in (ctrl, state, blk, best)]
        kb.block_record(ctrl, state, blk, best, k_min, strict)
        kb.block_record_reference(*held[:3], held[3], k_min, strict)
        err = max(err, *(_diff(a, b) for a, b in
                         zip((ctrl, state, blk, best), held)))
        held = [t.clone() for t in (ctrl, blk, state, live)]
        kb.block_start(ctrl, blk, state, live, ring, degrees, init_ba)
        kb.block_start_reference(*held, ring, degrees, init_ba)
        err = max(err, *(_diff(a, b) for a, b in
                         zip((ctrl, blk, state, live), held)))
    torch.cuda.synchronize()
    check(err == 0, f"K9/K10 disagree with their plain versions: max abs "
                    f"err {err}")
    return err


def _ts_ok(kernel: torch.Tensor, plain: torch.Tensor, timing: bool) -> bool:
    """The timestamp column (col 5) of a kernel's trajectory rows against
    its plain version's: −1 in the same rows, and where timing is on a
    masked clock reading (0 to ``US_MASK``) in the rows the plain version
    wrote, which read the host clock instead."""
    from dgc_tpu_torch.layout import COL_TS_US, US_MASK

    a, b = kernel[..., COL_TS_US], plain[..., COL_TS_US]
    if not timing:
        return bool((a == b).all())
    written = b >= 0
    return bool(((a == -1) == ~written).all()
                and ((a[written] >= 0) & (a[written] <= US_MASK)).all())


def _traj_diff(kernel: torch.Tensor, plain: torch.Tensor,
               timing: bool = False) -> int:
    """Max abs difference of two trajectory buffers over every column but
    the timestamp, which ``_ts_ok`` must accept (else a failure)."""
    from dgc_tpu_torch.layout import COL_TS_US

    keep = [c for c in range(kernel.shape[-1]) if c != COL_TS_US]
    err = _diff(kernel[..., keep], plain[..., keep])
    return err if _ts_ok(kernel, plain, timing) else max(err, 1 << 40)


def phase_telemetry_kernels(device) -> int:
    """The recording variants (B11) vs their plain versions on seeded
    random cases: K2 writing rows into buffers that hold the step or not,
    K5 and K8 filling the unconf vector over the cases of
    ``phase_compact_kernels`` and ``phase_hub_kernels``, K6 writing rows
    from random loop carries and live tables with the clock on and off,
    K9 closing an attempt's span and K10 starting the next. Every column
    is exact but the timestamp (``_ts_ok``). Returns the max abs
    difference."""
    from dgc_tpu_torch.engine import hub as th
    from dgc_tpu_torch.kernels import block as kb
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.kernels import hub as kh
    from dgc_tpu_torch.kernels import superstep as ks
    from dgc_tpu_torch.obs.kernel import traj_empty
    from dgc_tpu_torch.ops.segmented_gather import (plan_from_parts,
                                                    plan_from_ranges)

    rng = np.random.default_rng(7)
    err = 0
    v = 5000

    def rand(lo, hi, *shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32)
                                ).to(device)

    # K2: random loop carries into buffers of 1 to 130 rows (the step is
    # in the buffer or past it), gather calls -1 or a bucket count
    for _ in range(300):
        step = int(rng.integers(0, 100))
        prev = int(rng.integers(0, 50))
        ctrl = torch.tensor(
            [int(rng.choice([0, 0, 0, 1, 2])), step, prev,
             int(rng.integers(0, 70)), int(rng.integers(0, 2)),
             int(rng.choice([0, 0, int(rng.integers(1, 5))])),
             int(rng.choice([0, prev, int(rng.integers(0, 60))])),
             int(rng.integers(-1, 9))], dtype=torch.int32, device=device)
        traj = traj_empty(int(rng.choice([1, 64, 130])), device=device)
        gcalls = int(rng.choice([-1, int(rng.integers(1, 20))]))
        c_p, t_p = ctrl.clone(), traj.clone()
        max_steps = int(rng.choice([ks.INT32_MAX, int(rng.integers(1, 110))]))
        ks.superstep_finish(ctrl, max_steps, 64, traj, gcalls)
        ks.superstep_finish_reference(c_p, max_steps, 64, t_p, gcalls)
        err = max(err, _diff(ctrl, c_p), _traj_diff(traj, t_p))

    # K5 over slot lists and row spans, live and not, into a random column
    flat_ext = torch.from_numpy(np.concatenate([
        _combined(rng, (v, 1040), v), np.full((1, 1040), v, np.int32)])
    ).to(device)
    k5_cases = []
    for ranges in K4_RANGES:
        plan = plan_from_ranges(ranges)
        act = torch.from_numpy(rng.random(v) < 0.3).to(device)
        idx = kc.compact_idx(act, ranges[-1][1], v)
        seg, gidx = kc.stage_rows_reference(flat_ext, idx, plan, 0, v)
        k5_cases.append((plan, seg, gidx, 0))
    for sizes, widths, planes in K5_PARTS:
        plan = plan_from_parts(sizes, widths, planes)
        seg = torch.from_numpy(_combined(
            rng, sum(a * w for a, w in zip(sizes, widths)), v)).to(device)
        k5_cases += [(plan, seg, None, 0), (plan, seg, None, 1000)]
    k5_cases += _k5_width_cases(rng, v, device)
    for plan, seg, gidx, row_base in k5_cases:
        desc = kc.plan_desc(plan, device)
        for k in (1, 33, 5000):
            for status, prev, step in ((0, v, 3), (0, v, 3), (1, v, 3),
                                       (0, 10, 3)):
                state = _compact_state(
                    rng, v, 32 * max(s_.planes for s_ in plan) + 40,
                    float(rng.choice([0.05, 0.4, 1.0])), device)
                ctrl = kc.new_ctrl(step, prev, device)
                ctrl[kc.CTRL_STATUS] = status
                ctrl[kc.CTRL_CUR] = int(rng.integers(0, 2))
                umax = rand(0, 30, 4)
                ucol = int(rng.integers(0, 4))
                s_p, c_p, u_p = state.clone(), ctrl.clone(), umax.clone()
                kc.segmented_superstep(ctrl, state, seg, plan, desc, k, 10,
                                       50, gidx=gidx, row_base=row_base,
                                       umax=umax, ucol=ucol)
                kc.segmented_superstep_reference(
                    c_p, s_p, seg, plan, k, 10, 50, gidx=gidx,
                    row_base=row_base, umax=u_p, ucol=ucol)
                err = max(err, _diff(state, s_p), _diff(ctrl, c_p),
                          _diff(umax, u_p))

    # K6: random loop carries and live tables, the clock on and off, rows
    # in and past the buffer, with and without the ring
    for trial in range(300):
        state = _compact_state(rng, v, 200, 0.3, device)
        nh = int(rng.integers(0, 8))
        nb = nh + (1 if nh == 0 else int(rng.integers(0, 2)))
        ring = (rand(-1, 99, kc.REC_SLOTS, v + 2), rand(-1, 99, kc.REC_SLOTS,
                                                          nb),
                rand(-1, 99, kc.REC_SLOTS, kc.META_COLS))
        live = rand(-1, 99, kc.LIVE_ROWS, nb)
        prev = int(rng.integers(0, 50))
        ctrl = torch.tensor(
            [int(rng.choice([0, 0, 0, 1, 2])), int(rng.integers(0, 100)),
             prev, int(rng.integers(0, 70)), int(rng.integers(0, 2)),
             int(rng.choice([0, 0, int(rng.integers(1, 5))])),
             int(rng.choice([0, prev, int(rng.integers(0, 60))])),
             int(rng.integers(-1, 40)), int(rng.integers(0, 9)),
             int(rng.integers(-1, 40)), 0], dtype=torch.int32, device=device)
        timing = trial % 2 == 1
        tel = kc.Telemetry(traj_empty(int(rng.choice([1, 60, 120])), nb,
                                      unconf_b=True, device=device),
                           rand(0, 40, nb), rand(0, 2, nb),
                           int(rng.integers(0, 3)), timing)
        record = bool(rng.integers(0, 2))
        thresh = int(rng.choice([0, 0, int(rng.integers(0, 60))]))
        max_steps = int(rng.choice([kc.INT32_MAX, int(rng.integers(1, 110))]))
        c_p, s_p, l_p = ctrl.clone(), state.clone(), live.clone()
        r_p = tuple(t.clone() for t in ring)
        t_p = kc.Telemetry(tel.traj.clone(), tel.umax.clone(), tel.gc_w,
                           tel.gc_const, timing)
        kc.stage_finish(ctrl, state, ring, live, nh, thresh, max_steps, 64,
                        record, tel=tel)
        kc.stage_finish_reference(c_p, s_p, r_p, l_p, nh, thresh, max_steps,
                                  64, record, tel=t_p)
        err = max(err, _diff(ctrl, c_p), _diff(state, s_p), _diff(live, l_p),
                  *(_diff(a, b) for a, b in zip(ring, r_p)),
                  _diff(tel.umax, t_p.umax),
                  _traj_diff(tel.traj, t_p.traj, timing))

    # K8 over the random hub regions of phase_hub_kernels, K7's plain
    # version choosing the branches
    sizes = [b_[0] for b_ in HUB_BUCKETS]
    widths = [b_[1] for b_ in HUB_BUCKETS]
    prune = tuple(b_[2] if isinstance(b_[2], tuple) else None
                  for b_ in HUB_BUCKETS)
    uncond = tuple(b_[2] == "uncond" for b_ in HUB_BUCKETS)
    row0s = np.concatenate([[0], np.cumsum(sizes[:-1])]) + 37
    table = torch.from_numpy(_combined(
        rng, sum(r * w for r, w in zip(sizes, widths)), v)).to(device)
    branches = set()
    for trial in range(72):
        planes = ((1,) * 6 if trial % 3 == 0 else (32,) * 6 if trial % 3 == 1
                  else tuple(int(p) for p in rng.choice([1, 2, 3, 32], 6)))
        plan = kh.hub_plan(row0s, sizes, widths, planes, prune, uncond,
                           device, table=table, v=v)
        pool = kh.new_pool(plan, device)
        _hub_pool(rng, plan, pool, device)
        live = rand(-5, 50, kc.LIVE_ROWS, len(sizes) + 1)
        for bi, b in enumerate(plan.buckets):
            cuts = [0, 1, b.pad, b.pad + 1, b.rows, b.p2, b.p2 + 1]
            live[kc.LIVE_BA, bi] = int(rng.choice([c for c in cuts
                                                   if 0 <= c <= b.rows]))
            live[kc.LIVE_TIER, bi] = int(rng.integers(0, 3 if b.p2 else
                                                      2 if b.u else 1))
        state = _compact_state(rng, v, 32 * max(planes) + 40,
                               float(rng.choice([0.02, 0.3, 1.0])), device)
        ctrl = kc.new_ctrl(3, v, device)
        ctrl[kc.CTRL_CUR] = trial % 2
        if trial % 9 == 8:  # a stage that is not live
            ctrl[kc.CTRL_STATUS] = 1
        k = int(rng.choice([1, 33, 32 * max(planes) + 7, v]))
        kh.hub_slots_reference(ctrl, state, live, plan, pool, 10, 50)
        if trial % 9 != 8:
            branches |= set(live[kc.LIVE_BRANCH, :len(sizes)].tolist())
        umax = rand(0, 9, len(sizes) + 1)
        c_p, s_p, l_p, p_p, u_p = (t.clone() for t in
                                   (ctrl, state, live, pool, umax))
        kh.hub_superstep(ctrl, state, table, live, plan, pool, k, 10, 50,
                         umax=umax)
        kh.hub_superstep_reference(c_p, s_p, table, l_p, plan, p_p, k, 10, 50,
                                   umax=u_p)
        err = max(err, _diff(ctrl, c_p), _diff(state, s_p), _diff(live, l_p),
                  _diff(pool, p_p), _diff(umax, u_p))
    check(branches == set(range(len(th.BRANCH_NAMES))),
          f"the recording K8 reached only the branches {sorted(branches)}")
    err = max(err, _k5_replays(kc, rng, v, device, rec=True),
              _k8_wide_cases(rng, device, rec=True))

    # K9 and K10 over random blocks, with a random span and stack
    for trial in range(120):
        v_b = int(rng.choice([1, 7, 5000, 140_000]))
        attempts = int(rng.choice([1, 2, 4]))
        ctrl, state, blk, ring, degrees, live, init_ba, best = _block_case(
            rng, v_b, int(rng.choice([1, 3])), attempts, device)
        cap = int(rng.choice([1, 40, 4096]))
        traj = rand(-1, 99, cap, 8)
        tstack = rand(-1, 99, attempts, cap, 8)
        k_min = int(rng.integers(-2, 70))
        strict = bool(trial % 2)
        held = [t.clone() for t in (ctrl, state, blk, best, traj, tstack)]
        kb.block_record(ctrl, state, blk, best, k_min, strict, traj=traj,
                        tstack=tstack)
        kb.block_record_reference(*held[:4], k_min, strict, traj=held[4],
                                  tstack=held[5])
        err = max(err, *(_diff(a, b) for a, b in
                         zip((ctrl, state, blk, best, traj, tstack), held)))
        held = [t.clone() for t in (ctrl, blk, state, live, traj)]
        kb.block_start(ctrl, blk, state, live, ring, degrees, init_ba,
                       traj=traj)
        kb.block_start_reference(*held[:4], ring, degrees, init_ba,
                                 traj=held[4])
        err = max(err, *(_diff(a, b) for a, b in
                         zip((ctrl, blk, state, live, traj), held)))
    torch.cuda.synchronize()
    check(err == 0, f"the recording kernels disagree with their plain "
                    f"versions: max abs err {err}")
    return err


# ---- phase 2: engines vs the CPU --------------------------------------------

def _attempt_rows(result) -> list[tuple]:
    return [(a.k, int(a.status), a.supersteps, a.colors_used)
            for a in result.attempts]


def phase_engines(device, v: int = SMOKE_V) -> list[dict]:
    from dgc_tpu_torch.cli import make_engine
    from dgc_tpu_torch.engine.minimal_k import find_minimal_coloring, make_validator
    from dgc_tpu_torch.engine.compact import CompactFrontierEngine
    from dgc_tpu_torch.models.graph import Graph

    def cli(backend):
        return lambda g, dev: make_engine(
            argparse.Namespace(backend=backend, device=dev), g)

    def compact(**knobs):
        return lambda g, dev: CompactFrontierEngine(g.arrays, device=dev,
                                                    **knobs)

    uniform = Graph.generate(v, 32, seed=1, method="fast")
    rmat = Graph.generate(v, 32, seed=2, method="rmat")
    graphs = [
        ("uniform", uniform, (("ell-compact", cli("ell-compact")),
                              ("ell-bucketed", cli("ell-bucketed")),
                              ("ell", cli("ell")))),
        ("rmat", rmat, (
            # a flat_cap past the widest bucket: hub-free
            ("ell-compact flat_cap>max", compact(
                flat_cap=max(256, 1 << rmat.max_degree.bit_length()))),
            # the CLI's default knobs: hub buckets, all unconditioned
            ("ell-compact", cli("ell-compact")),
            # forced knobs: the conditioned ladder, every branch
            ("ell-compact forced", compact(flat_cap=8, prune_u_min=4,
                                           hub_uncond_entries=0)),
            ("ell-bucketed", cli("ell-bucketed")))),
        # every bucket a hub, no prune config: the compact branch
        ("uniform", uniform, (("ell-compact flat_cap=4", compact(
            flat_cap=4, hub_uncond_entries=0)),)),
    ]
    # the hub branches a case exists for, seen on one held sweep of it
    must_take = {"ell-compact forced": {"rebase", "pruned", "shrink",
                                        "pruned2"},
                 "ell-compact flat_cap=4": {"compact"}}
    rows = []
    for gname, graph, backends in graphs:
        for backend, make in backends:
            k0 = graph.initial_k()
            for strict in (False, True):
                if strict and gname == "rmat":
                    # the hub degree puts k0 in the hundreds; start the
                    # strict chain a few budgets above the jump result
                    k0 = rows[-1]["colors"] + 3
                runs = {}
                for dev in (device, "cpu"):
                    runs[dev] = find_minimal_coloring(
                        make(graph, dev), k0, strict_decrement=strict,
                        validate=make_validator(graph.arrays))
                a, b = runs[device], runs["cpu"]
                same = (_attempt_rows(a) == _attempt_rows(b)
                        and np.array_equal(a.colors, b.colors))
                check(same, f"{backend} on {gname} (strict={strict}) differs "
                            f"from its CPU run: {_attempt_rows(a)} vs "
                            f"{_attempt_rows(b)}")
                rows.append({"graph": gname, "backend": backend,
                             "strict": strict, "k0": k0,
                             "attempts": len(a.attempts),
                             "colors": a.minimal_colors})
                if backend.startswith("ell-compact"):
                    rows[-1]["blocks"] = _blocked_matches(
                        make, graph, k0, strict, _attempt_rows(b), b.colors,
                        device, make_validator(graph.arrays))
            if backend in must_take:
                with _HeldCompactKernels() as held:
                    make(graph, device).sweep(graph.initial_k())
                taken = {b for seen in held.branches.values() for b in seen}
                check(held.err == 0, f"{backend} on {gname}: K3-K8 disagree "
                                     f"with their plain versions ({held.err})")
                check(must_take[backend] <= taken,
                      f"{backend} on {gname} took only the branches {taken}")
                rows[-1]["branches"] = sorted(taken)
    rows += _edge_cases(device)
    return rows


def _same_trajectories(a, b, what: str, timing: bool) -> None:
    """Results ``a`` (the card's, timed when ``timing``) and ``b`` (the
    CPU's, untimed) equal, trajectories included but for ``step_us``,
    which the card's must carry when timed: −1 first, non-negative after."""
    check((a is None) == (b is None), f"{what}: one result is missing")
    if a is None:
        return
    check((a.k, a.status, a.supersteps) == (b.k, b.status, b.supersteps)
          and (a.colors is None or np.array_equal(a.colors, b.colors)),
          f"{what}: k={a.k} differs from its CPU run")
    x, y = a.trajectory.to_dict(), b.trajectory.to_dict()
    su = x.pop("step_us", None)
    y.pop("step_us", None)
    check(x == y, f"{what}: k={a.k}: the trajectory differs from the CPU's")
    check((su is not None) == timing and (
        su is None or (su[0] == -1 and all(u >= 0 for u in su[1:]))),
          f"{what}: k={a.k}: step_us {su}")
    check(a.trajectory.first_step + len(a.trajectory) == a.supersteps,
          f"{what}: k={a.k}: rows do not span the attempt")


def phase_telemetry_engines(device, v: int = SMOKE_V) -> list[dict]:
    """The engines with telemetry on (the recording kernels) against
    their CPU runs: ``ell-compact`` on a uniform and an RMAT graph at the
    default and forced knobs (every conditioned branch), sweeps with the
    card's clock on, and the strict and jump blocks at A = 4;
    ``ell-bucketed`` and ``ell`` attempts. Every result and trajectory
    equals the CPU's but for ``step_us``; telemetry off gives the same
    results."""
    from dgc_tpu_torch.engine.bucketed import BucketedELLEngine
    from dgc_tpu_torch.engine.compact import CompactFrontierEngine
    from dgc_tpu_torch.engine.minimal_k import find_minimal_coloring
    from dgc_tpu_torch.engine.superstep import ELLEngine
    from dgc_tpu_torch.models.graph import Graph

    uniform = Graph.generate(v, 32, seed=1, method="fast")
    rmat = Graph.generate(v, 32, seed=2, method="rmat")
    cases = [("uniform", uniform, {}), ("rmat", rmat, {}),
             ("rmat forced", rmat, dict(flat_cap=8, prune_u_min=4,
                                        hub_uncond_entries=0))]
    rows = []
    for name, graph, knobs in cases:
        def make(dev, rec=True, knobs=knobs, graph=graph):
            e = CompactFrontierEngine(graph.arrays, device=dev, **knobs)
            e.record_trajectory = rec
            e.record_timing = rec and dev == device
            return e

        k0 = graph.initial_k()
        card, cpu, off = make(device), make("cpu"), make(device, False)
        for a, b, c in zip(card.sweep(k0), cpu.sweep(k0), off.sweep(k0)):
            _same_trajectories(a, b, f"{name} sweep", True)
            check(a is None or (c.trajectory is None and np.array_equal(
                a.colors, c.colors) and a.supersteps == c.supersteps),
                  f"{name}: telemetry on and off differ")
        used = [r for r in cpu.sweep(k0) if r is not None][0].colors_used
        for strict, start in ((True, used + 2), (False, k0)):
            runs = [find_minimal_coloring(make(dev), start,
                                          strict_decrement=strict,
                                          attempts_per_dispatch=4)
                    for dev in (device, "cpu")]
            check(len(runs[0].attempts) == len(runs[1].attempts),
                  f"{name}: blocked attempt counts differ")
            for a, b in zip(*(r.attempts for r in runs)):
                _same_trajectories(a, b, f"{name} block strict={strict}",
                                   True)
        rows.append({"graph": name, "k0": k0, "colors": used,
                     "confirm_resumed_from_step": card.resumed_from_step})
    for name, cls in (("ell-bucketed", BucketedELLEngine), ("ell", ELLEngine)):
        engines = [cls(uniform.arrays, device=dev) for dev in (device, "cpu")]
        for e in engines:
            e.record_trajectory = True
        for k in (uniform.initial_k(), 9):
            a, b = (e.attempt(k) for e in engines)
            _same_trajectories(a, b, name, False)
        rows.append({"graph": "uniform", "backend": name})
    return rows


def _edge_cases(device) -> list[dict]:
    """Single attempts (and the compact engine's sweeps) on small graphs
    that take the engines' rare paths: K40 under a 1-plane window cap
    (capped fail gate, STALLED, widening), isolated vertices, compaction
    stages at that size, and budgets below 1 (no launch at all)."""
    from dgc_tpu_torch.engine.bucketed import BucketedELLEngine
    from dgc_tpu_torch.engine.compact import CompactFrontierEngine
    from dgc_tpu_torch.engine.superstep import ELLEngine
    from dgc_tpu_torch.models.arrays import GraphArrays

    k40 = GraphArrays.from_edge_list(
        40, np.array([[i, j] for i in range(40) for j in range(i + 1, 40)]))
    iso = GraphArrays.from_neighbor_lists([[], [2, 3], [1], [1], [], [6], [5], []])
    cases = [
        ("k40-cap1", lambda d: BucketedELLEngine(k40, max_window_planes=1,
                                                 device=d), (41, 40, 39, 32, 0)),
        ("k40-ell", lambda d: ELLEngine(k40, device=d), (41, 40, 39, 1)),
        ("isolated-bucketed", lambda d: BucketedELLEngine(iso, device=d),
         (3, 2, 1, 0, -1)),
        ("isolated-ell", lambda d: ELLEngine(iso, device=d), (3, 2, 1, 0)),
        ("k40-cap1-compact", lambda d: CompactFrontierEngine(
            k40, max_window_planes=1, stages=((None, 0),), device=d),
         (41, 40, 39, 32, 0)),
        ("isolated-compact", lambda d: CompactFrontierEngine(
            iso, stages=((None, 4), (4, 0)), device=d), (3, 2, 1, 0, -1)),
    ]
    rows = []
    for name, make, budgets in cases:
        engines = {d: make(d) for d in (device, "cpu")}
        for k in budgets:
            a, b = (engines[d].attempt(k) for d in (device, "cpu"))
            check((a.status, a.supersteps) == (b.status, b.supersteps)
                  and np.array_equal(a.colors, b.colors),
                  f"{name} at k={k} differs from its CPU run")
        if hasattr(engines["cpu"], "sweep"):
            engines = {d: make(d) for d in (device, "cpu")}
            pairs = [engines[d].sweep(budgets[0]) for d in (device, "cpu")]
            for a, b in zip(*pairs):
                check((a is None) == (b is None) and (
                    a is None or ((a.status, a.supersteps, a.k)
                                  == (b.status, b.supersteps, b.k)
                                  and np.array_equal(a.colors, b.colors))),
                      f"{name}: sweep({budgets[0]}) differs from its CPU run")
        rows.append({"graph": name, "budgets": list(budgets),
                     "status": a.status.name})
    return rows


# ---- the dense engine: K11 and K12, and the engine vs the CPU ---------------

def _dense_case(rng, v: int, avg: float, hubs: int, max_color: int,
                uncolored: float, device):
    """A random 0/1 adjacency on ``v`` vertices padded to the vertex tile
    (average degree ``avg``, the last 5% isolated, and ``hubs`` rows joined
    to a quarter of the graph or more whose neighbors hold the colors
    0, 1, 2, ... so their first fit lies in a late column tile), its
    degrees, and two color buffers with −1s at rate ``uncolored``."""
    from dgc_tpu_torch.kernels import dense as kd

    vp = kd.padded_size(v)
    iso = v - max(1, v // 20)
    m = int(v * avg / 2) if iso > 1 else 0
    src = [rng.integers(0, max(iso, 1), m)]
    dst = [rng.integers(0, max(iso, 1), m)]
    colors = np.where(rng.random(v) < uncolored, -1,
                      rng.integers(0, max_color, v))
    for _ in range(hubs):
        h = int(rng.integers(0, iso))
        n = int(rng.integers(iso // 4, iso - 1))
        nb = rng.choice(iso, size=n, replace=False)
        src.append(np.full(n, h))
        dst.append(nb)
        c_h = int(rng.integers(0, min(n, max_color)))
        colors[nb[:c_h]] = np.arange(c_h)
    src, dst = np.concatenate(src), np.concatenate(dst)
    keep = src != dst
    s = torch.from_numpy(src[keep]).to(device)
    d = torch.from_numpy(dst[keep]).to(device)
    adj = torch.zeros((vp, vp), dtype=torch.bfloat16, device=device)
    adj[s, d] = 1
    adj[d, s] = 1
    degrees = (adj != 0).sum(dim=1).to(torch.int32)
    buf = np.full((2, vp), -1, np.int32)
    buf[0, :v] = colors
    buf[1, :v] = rng.permutation(colors)
    return adj, degrees, torch.from_numpy(buf).to(device)


# (v, average degree, hubs, colors drawn below, budgets): V below, at and
# past a multiple of the 256-vertex tile; budgets up to 128 and 2,432
DENSE_CASES = (
    (1, 0, 0, 1, (1, 2)),
    (64, 6, 0, 5, (1, 3, 6, 128)),
    (512, 8, 1, 40, (1, 9, 41, 128)),
    (1000, 16, 0, 20, (1, 5, 12, 21, 128)),
    (1500, 16, 2, 300, (4, 100, 200, 301, 384)),
    (5000, 16, 6, 2432, (1, 300, 1500, 2000, 2432)),
)


# K11's edge rows (row, its neighbors' first id, the colors 0..n-1 they
# hold): a first free color past the first 32-bit word of the mask (40),
# at the first bit of the second word (32), every color below 64 taken
# (free only from k = 65), and the last bit of a 2,432-bit mask (2,431);
# a budget past Vp (4,096 over 3,072) bounds the mask by Vp
DENSE_EDGE_ROWS = ((0, 1, 40), (41, 42, 32), (100, 101, 64), (200, 201, 2431))
DENSE_EDGE_V = 3000
DENSE_EDGE_BUDGETS = (1, 32, 33, 40, 41, 64, 65, 2431, 2432, 4096)


def _dense_edges(device):
    """The adjacency, degrees and color buffers of ``DENSE_EDGE_ROWS``: each
    edge row uncolored and joined to its colored neighbors; row 2,700
    joined to neighbors whose colors lie at and past 2,432 (never
    forbidden below it); every other row uncolored and isolated. Buffer 1
    colors every row (a step with no uncolored row)."""
    from dgc_tpu_torch.kernels import dense as kd

    v = DENSE_EDGE_V
    vp = kd.padded_size(v)
    colors = np.full(v, -1, np.int64)
    src, dst = [], []
    for row, first, n in DENSE_EDGE_ROWS:
        nb = np.arange(first, first + n)
        colors[nb] = np.arange(n)
        src.append(np.full(n, row))
        dst.append(nb)
    far = np.arange(2701, 2711)
    colors[far] = 2432 + np.arange(10) * 1000
    src.append(np.full(far.size, 2700))
    dst.append(far)
    s_ = torch.from_numpy(np.concatenate(src)).to(device)
    d_ = torch.from_numpy(np.concatenate(dst)).to(device)
    adj = torch.zeros((vp, vp), dtype=torch.bfloat16, device=device)
    adj[s_, d_] = 1
    adj[d_, s_] = 1
    degrees = (adj != 0).sum(dim=1).to(torch.int32)
    buf = np.full((2, vp), -1, np.int32)
    buf[0, :v] = colors
    buf[1, :v] = np.where(colors < 0, np.arange(v) % 7, colors)
    return adj, degrees, torch.from_numpy(buf).to(device)


def _dense_edge_cases(device) -> int:
    """K11 then K12 against their plain versions on ``_dense_edges``'
    buffers at ``DENSE_EDGE_BUDGETS``, either buffer current (buffer 1:
    no uncolored row). Checks the first fits the edge rows must take;
    returns the max abs difference."""
    from dgc_tpu_torch.kernels import dense as kd

    adj, degrees, state0 = _dense_edges(device)
    v = DENSE_EDGE_V
    err = 0
    for cur in (0, 1):
        for k in DENSE_EDGE_BUDGETS:
            ctrl = kd.new_dense_ctrl(device)
            ctrl[kd.DCTRL_CUR] = cur
            state = state0.clone()
            cand = torch.full((adj.shape[0],), 7, dtype=torch.int32,
                              device=device)
            held = [t.clone() for t in (ctrl, state, cand)]
            kd.dense_forbid(ctrl, state, adj, cand, v, k)
            kd.dense_forbid_reference(*held[:2], adj, held[2], v, k)
            err = max(err, *(_diff(a, b) for a, b in
                             zip((ctrl, state, cand), held)))
            got = cand.tolist()
            want = {row: (n if n < k else 0) for row, _f, n in
                    DENSE_EDGE_ROWS} if cur == 0 else {}
            check(all(got[r] == c for r, c in want.items())
                  and (cur == 0 or max(got) == -1),
                  f"K11's edge rows at k={k}, buffer {cur}: "
                  f"{[got[r] for r in want]}, want {list(want.values())}")
            kd.dense_resolve(ctrl, state, adj, cand, degrees, v,
                             kd.INT32_MAX)
            kd.dense_resolve_reference(held[0], held[1], adj, held[2],
                                       degrees, v, kd.INT32_MAX)
            err = max(err, *(_diff(a, b) for a, b in
                             zip((ctrl, state, cand), held)))
    return err


# K12's layout cases (v, hub rows, candidates drawn from [lo, hi), degrees
# from [dlo, dhi)): v off a 16-byte word and off the 256-vertex tile, hub
# rows of thousands of neighbors (rows several times the grid), and
# v = 16,384 with candidates and degrees near 16,383, the int16 edge
K12_CASES = ((1003, 2, 0, 6, 0, 4), (4101, 3, 0, 40, 0, 9),
             (16384, 4, 16376, 16384, 16370, 16384))


def _k12_rows(rng, v: int, hubs: int, lo: int, hi: int, dlo: int, dhi: int,
              device):
    """K12's inputs drawn directly (no K11 before it) on ``v`` >= 24
    vertices: a symmetric random 0/1 adjacency among the rows below
    ``base`` (the last multiple of 8 at or below v - 16; about 12 a row,
    ``hubs`` rows joined to a third of the graph), degrees drawn from [dlo,
    dhi) (ties common), about 60 % of the rows uncolored with candidates
    drawn from [lo, hi) (-1 for the others and the pads), colors below
    ``hi`` in buffer 0. Then the edge rows: row ``a`` = base whose only
    same-candidate neighbor, v - 1, sits in the last 16-byte word of the
    graph's columns and beats it by degree; row ``b`` = base + 5 beaten by
    base + 4, in its word, at equal degree and a lower id; row ``c`` = base
    + 6 not beaten by base + 7 at equal degree and a higher id; row ``d`` =
    base + 9 whose neighbor base + 2 holds ``d``'s candidate as its color
    (cand -1): no beater. Returns the adjacency, degrees, color buffers,
    candidates and (a, b, c, d)."""
    from dgc_tpu_torch.kernels import dense as kd

    vp = kd.padded_size(v)
    base = (v - 16) & ~7
    m = 6 * v
    src = [rng.integers(0, base, m)]
    dst = [rng.integers(0, base, m)]
    for _ in range(hubs):
        n = v // 3
        src.append(np.full(n, rng.integers(0, base)))
        dst.append(rng.choice(base, size=n, replace=False))
    src, dst = np.concatenate(src), np.concatenate(dst)
    keep = src != dst
    src, dst = list(src[keep]), list(dst[keep])
    deg = rng.integers(dlo, dhi, vp).astype(np.int32)
    deg[v:] = 0
    uncol = rng.random(v) < 0.6
    cand = np.full(vp, -1, np.int32)
    cand[:v] = np.where(uncol, rng.integers(lo, hi, v), -1)
    colors = np.full(vp, -1, np.int32)
    colors[:v] = np.where(uncol, -1, rng.integers(0, hi, v))
    a, b, c, d = base, base + 5, base + 6, base + 9
    for row, nb, cand_both, deg_row, deg_nb in (
            (a, v - 1, hi - 1, dlo, dhi - 1), (b, base + 4, lo, dlo, dlo),
            (c, base + 7, lo + 1, dlo, dlo)):
        src.append(row)
        dst.append(nb)
        cand[row] = cand[nb] = cand_both
        deg[row], deg[nb] = deg_row, deg_nb
        colors[row] = colors[nb] = -1
    e = base + 2
    src.append(d)
    dst.append(e)
    cand[d], colors[d] = hi - 2, -1
    cand[e], colors[e] = -1, hi - 2
    s_ = torch.tensor(src, device=device)
    t_ = torch.tensor(dst, device=device)
    adj = torch.zeros((vp, vp), dtype=torch.bfloat16, device=device)
    adj[s_, t_] = 1
    adj[t_, s_] = 1
    state = torch.full((2, vp), -1, dtype=torch.int32, device=device)
    state[0] = torch.from_numpy(colors).to(device)
    return (adj, torch.from_numpy(deg).to(device), state,
            torch.from_numpy(cand).to(device), (a, b, c, d))


def _k12_cases(device) -> int:
    """K12 against its plain version on ``K12_CASES``' draws (``_k12_rows``),
    either buffer current: a step that resolves, one that reaches
    ``max_steps``, one that failed (K11's fail count set: nothing written);
    the edge rows must come out as drawn (a, b beaten; c, d keep their
    candidate). Returns the max abs difference."""
    from dgc_tpu_torch.kernels import dense as kd

    rng = np.random.default_rng(12)
    err = 0
    for v, hubs, lo, hi, dlo, dhi in K12_CASES:
        adj, deg, state0, cand, (a, b, c, d) = _k12_rows(
            rng, v, hubs, lo, hi, dlo, dhi, device)
        for cur, fail, max_steps in ((0, 0, kd.INT32_MAX), (1, 0, 1),
                                     (0, 3, kd.INT32_MAX)):
            state = state0.flip(0).contiguous() if cur else state0.clone()
            ctrl = kd.new_dense_ctrl(device)
            ctrl[kd.DCTRL_CUR], ctrl[kd.DCTRL_FAIL] = cur, fail
            held = [t.clone() for t in (ctrl, state)]
            kd.dense_resolve(ctrl, state, adj, cand, deg, v, max_steps)
            kd.dense_resolve_reference(held[0], held[1], adj, cand, deg, v,
                                       max_steps)
            err = max(err, *(_diff(x, y) for x, y in
                             zip((ctrl, state), held)))
            if fail:
                check(torch.equal(state, state0.flip(0) if cur else state0),
                      f"K12 at v={v}: a failed step wrote a color")
                continue
            new = state[1 - cur].tolist()
            check([new[r] for r in (a, b, c, d)]
                  == [-1, -1, int(cand[c]), int(cand[d])],
                  f"K12's edge rows at v={v}: {[new[r] for r in (a, b, c, d)]}")
    torch.cuda.synchronize()
    return err


def phase_dense_kernels(device) -> int:
    """K11 and K12 vs their plain versions on seeded random cases: colors
    with −1s (none, some, all), either buffer current, budgets below and
    above the colors in use, isolated and pad rows, budgets up to 128 and
    2,432, a step that fails, one that reaches ``max_steps``, the edge rows
    of ``_dense_edge_cases``, K12's layout cases (``_k12_cases``) and an
    attempt no longer running; returns the max abs difference."""
    from dgc_tpu_torch.kernels import dense as kd

    rng = np.random.default_rng(6)
    err = 0
    cases = 0
    for v, avg, hubs, max_color, budgets in DENSE_CASES:
        for uncolored in (0.0, 0.4, 1.0):
            adj, degrees, state0 = _dense_case(rng, v, avg, hubs, max_color,
                                               uncolored, device)
            for k in budgets:
                ctrl = kd.new_dense_ctrl(device)
                ctrl[kd.DCTRL_CUR] = cases % 2
                ctrl[kd.DCTRL_STEP] = int(rng.integers(0, 9))
                max_steps = int(rng.choice([kd.INT32_MAX, 1,
                                            int(ctrl[kd.DCTRL_STEP]) + 1]))
                state = state0.clone()
                cand = torch.full((adj.shape[0],), 7, dtype=torch.int32,
                                  device=device)
                held = [t.clone() for t in (ctrl, state, cand)]
                kd.dense_forbid(ctrl, state, adj, cand, v, k)
                kd.dense_forbid_reference(*held[:2], adj, held[2], v, k)
                err = max(err, *(_diff(a, b) for a, b in
                                 zip((ctrl, state, cand), held)))
                kd.dense_resolve(ctrl, state, adj, cand, degrees, v,
                                 max_steps)
                kd.dense_resolve_reference(held[0], held[1], adj, held[2],
                                           degrees, v, max_steps)
                err = max(err, *(_diff(a, b) for a, b in
                                 zip((ctrl, state, cand), held)))
                cases += 1
    err = max(err, _dense_edge_cases(device), _k12_cases(device))
    # an attempt that already left RUNNING: neither kernel touches anything
    ctrl = kd.new_dense_ctrl(device)
    ctrl[kd.DCTRL_STATUS] = 1
    cand = torch.full((adj.shape[0],), 7, dtype=torch.int32, device=device)
    before = [t.clone() for t in (ctrl, state0, cand)]
    kd.dense_forbid(ctrl, state0, adj, cand, v, 5)
    kd.dense_resolve(ctrl, state0, adj, cand, degrees, v, kd.INT32_MAX)
    err = max(err, *(_diff(a, b) for a, b in
                     zip((ctrl, state0, cand), before)))
    torch.cuda.synchronize()
    check(err == 0, f"K11/K12 disagree with their plain versions: max abs "
                    f"err {err}")
    return err


DENSE_SMOKE_V = 2000


def phase_dense_engines(device) -> list[dict]:
    """The dense engine on the card against its CPU run: sweeps on a
    2,000-vertex uniform and RMAT graph (jump, and strict from a few
    budgets above the jump result), and single attempts at budgets below
    1, above kmax (equal to the k0 attempt) and under a ``max_steps`` that
    stalls."""
    from dgc_tpu_torch.engine.dense_engine import DenseEngine
    from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,
                                                make_validator)
    from dgc_tpu_torch.models.graph import Graph

    rows = []
    for gen in ("fast", "rmat"):
        graph = Graph.generate(DENSE_SMOKE_V, 32, seed=1, method=gen)
        k0 = graph.initial_k()
        for strict in (False, True):
            if strict:
                k0 = rows[-1]["colors"] + 3
            runs = [find_minimal_coloring(
                DenseEngine(graph.arrays, device=d), k0,
                strict_decrement=strict, validate=make_validator(graph.arrays))
                for d in (device, "cpu")]
            a, b = runs
            check(_attempt_rows(a) == _attempt_rows(b)
                  and np.array_equal(a.colors, b.colors),
                  f"dense on {gen} (strict={strict}) differs from its CPU "
                  f"run: {_attempt_rows(a)} vs {_attempt_rows(b)}")
            rows.append({"graph": gen, "backend": "dense", "strict": strict,
                         "k0": k0, "attempts": _attempt_rows(a),
                         "colors": a.minimal_colors})
        engines = {d: DenseEngine(graph.arrays, device=d)
                   for d in (device, "cpu")}
        stall = {d: DenseEngine(graph.arrays, max_steps=2, device=d)
                 for d in (device, "cpu")}
        kmax = engines["cpu"].kmax
        for name, ens, k in (("k<1", engines, 0), ("k0", engines, k0),
                             ("k>kmax", engines, kmax + 50),
                             ("max_steps=2", stall, k0)):
            a, b = (ens[d].attempt(k) for d in (device, "cpu"))
            check((a.status, a.supersteps, a.k) == (b.status, b.supersteps,
                                                    b.k)
                  and np.array_equal(a.colors, b.colors),
                  f"dense {name} on {gen} differs from its CPU run")
            rows.append({"graph": gen, "backend": "dense", "case": name,
                         "k": k, "status": a.status.name,
                         "supersteps": a.supersteps})
        top, first = (engines[device].attempt(kmax + 50),
                      engines[device].attempt(graph.initial_k()))
        check((top.status, top.supersteps) == (first.status, first.supersteps)
              and np.array_equal(top.colors, first.colors),
              f"dense on {gen}: k > kmax differs from the k0 attempt")
        check(stall["cpu"].attempt(k0).status.name == "STALLED",
              f"dense on {gen}: max_steps=2 did not stall")
    return rows


BLOCK_SIZES = (2, 4)  # attempts per block on the card
# the long strict chain: RMAT, seed 1, average degree 16 (Δ 750 from the
# NumPy generator), from k = 465, about 450 attempts
CHAIN = dict(v=3000, seed=1, k0=465)


def _blocked_matches(make, graph, k0: int, strict: bool, ref_rows: list,
                     ref_colors: np.ndarray, device, validate) -> list[int]:
    """The blocked driver on the card at every ``BLOCK_SIZES``: each run's
    attempts and colors must equal the CPU sequential run's; returns the
    blocks each run took."""
    from dgc_tpu_torch.engine.minimal_k import find_minimal_coloring

    blocks = []
    for a in BLOCK_SIZES:
        seen = []
        got = find_minimal_coloring(
            make(graph, device), k0, strict_decrement=strict,
            validate=validate, attempts_per_dispatch=a,
            on_block=lambda k, n: seen.append(k))
        check(_attempt_rows(got) == ref_rows
              and np.array_equal(got.colors, ref_colors),
              f"the blocked driver at A={a} (strict={strict}, k0={k0}) "
              f"differs from the CPU sequential run: {_attempt_rows(got)} vs "
              f"{ref_rows}")
        blocks.append(len(seen))
    return blocks


def _chain_graph():
    from dgc_tpu_torch.models.graph import Graph

    return Graph.generate(CHAIN["v"], 32, seed=CHAIN["seed"], method="rmat")


def chain_reference() -> dict:
    """The long chain's CPU sequential runs, strict and jump, on one thread
    (run in a child process beside the card's phases): per mode the
    attempts, the colors and the seconds."""
    from dgc_tpu_torch.engine.compact import CompactFrontierEngine
    from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,
                                                make_validator)

    torch.set_num_threads(1)
    graph = _chain_graph()
    out = {}
    for strict in (True, False):
        t = time.perf_counter()
        ref = find_minimal_coloring(
            CompactFrontierEngine(graph.arrays, device="cpu"), CHAIN["k0"],
            strict_decrement=strict, validate=make_validator(graph.arrays))
        out[strict] = (_attempt_rows(ref), ref.colors,
                       time.perf_counter() - t)
    return out


def phase_block_engines(device, reference: dict) -> list[dict]:
    """The long chain (``CHAIN``) strict and jump, blocked on the card at
    ``BLOCK_SIZES`` against ``reference`` (``chain_reference``); then the
    strict chain killed at a block boundary (an ``on_block`` that raises)
    and resumed from its checkpoint on the card equals the uninterrupted
    one."""
    from dgc_tpu_torch.engine.compact import CompactFrontierEngine
    from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,
                                                make_validator)
    from dgc_tpu_torch.utils.checkpoint import CheckpointManager

    def make(g, dev):
        return CompactFrontierEngine(g.arrays, device=dev)

    graph = _chain_graph()
    validate = make_validator(graph.arrays)
    k0 = CHAIN["k0"]
    rows = []
    for strict in (True, False):
        ref_rows, ref_colors, cpu_s = reference[strict]
        t = time.perf_counter()
        blocks = _blocked_matches(make, graph, k0, strict, ref_rows,
                                  ref_colors, device, validate)
        rows.append({"graph": f"rmat {CHAIN['v']} seed {CHAIN['seed']}",
                     "max_degree": graph.max_degree, "k0": k0,
                     "strict": strict, "attempts": len(ref_rows),
                     "blocks": blocks, "cpu_sequential_s": cpu_s,
                     "card_blocked_s": time.perf_counter() - t})

    class Kill(Exception):
        pass

    def killer(k, attempts):
        if len(seen) == 3:
            raise Kill
        seen.append(k)

    with tempfile.TemporaryDirectory() as d:
        seen, pre = [], []
        try:
            find_minimal_coloring(
                make(graph, device), k0, strict_decrement=True,
                validate=validate, checkpoint=CheckpointManager(d),
                attempts_per_dispatch=4, on_block=killer,
                on_attempt=lambda r, val: pre.append(r))
            raise SmokeFailure("the kill at a block boundary never fired")
        except Kill:
            pass
        post = find_minimal_coloring(
            make(graph, device), k0, strict_decrement=True,
            validate=validate, checkpoint=CheckpointManager(d),
            attempts_per_dispatch=4)
    resumed = [(a.k, int(a.status), a.supersteps, a.colors_used)
               for a in pre] + _attempt_rows(post)[1:]
    ref_rows, ref_colors, _ = reference[True]
    check(len(pre) == 12 and resumed == ref_rows
          and np.array_equal(post.colors, ref_colors),
          "the strict chain killed after 3 blocks of 4 did not resume "
          "exactly on the card")
    rows.append({"resume": "strict chain killed after 3 blocks of 4, "
                 "resumed from its checkpoint", "attempts_before_kill":
                 len(pre), "attempts_after": len(post.attempts) - 1})
    return rows


# ---- phase 3: the main path at full size ------------------------------------

def _cuda_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _host_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


# a profiler window drops some launch records (of 20 launches of a 5 µs
# kernel it kept 17 to 20): _device_ms takes a profile that kept at least
# this share of the named launches, and the mean over those it kept
_DEVICE_MS_KEPT = 0.5


def _device_ms(fn, reps: int, name: str | None = None,
               per_call: int = 1) -> float:
    """Device time per call of ``fn`` from ``torch.profiler``: the summed
    durations of the CUDA events whose name contains ``name`` (every
    device event when None). With a ``name``, ``fn`` launches ``per_call``
    such kernels a call, the profile must keep at least
    ``_DEVICE_MS_KEPT`` of them, and the time is their mean times
    ``per_call`` (the plain sum when it kept them all).
    Without a name, at least one event. A profile that falls short is
    taken again, five times at most, and then fails the run: the
    kernels' ``ms`` is device time, never a host-side or CUDA-event
    rate."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want = per_call * reps
    kept = []
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and (name is None or name in e.name)]
        total = sum(e.time_range.elapsed_us() for e in device) / 1e3
        if name is None and device:
            return total / reps
        if (name is not None
                and _DEVICE_MS_KEPT * want <= len(device) <= want):
            return total / len(device) * per_call
        kept.append(len(device))
    raise SmokeFailure(f"torch.profiler kept {kept} device events"
                       f"{'' if name is None else ' of ' + name}"
                       f"{'' if name is None else f', not {want},'} in 6 "
                       f"profiles")


class _TimedEngine:
    """Host wall time of each ``attempt`` call of the wrapped engine, and
    the results it returned."""

    def __init__(self, engine):
        self.engine = engine
        self.seconds: list[float] = []
        self.results: list = []

    def attempt(self, k: int):
        t = time.perf_counter()
        res = self.engine.attempt(k)
        self.seconds.append(time.perf_counter() - t)
        self.results.append(res)
        return res


class _TimedSweepEngine(_TimedEngine):
    """The same for an engine with a fused ``sweep``: one time per pair."""

    def sweep(self, k: int):
        t = time.perf_counter()
        pair = self.engine.sweep(k)
        self.seconds.append(time.perf_counter() - t)
        self.results += [r for r in pair if r is not None]
        return pair


def _engine_parts(engine, k: int):
    """(k passed to the kernel, packed0, step0, parts) of one attempt."""
    from dgc_tpu_torch.engine.base import clamp_budget
    from dgc_tpu_torch.engine.bucketed import fail_valid

    if hasattr(engine, "combined_buckets"):
        parts = [(r0, cb, plan, p, fail_valid(cb.shape[1], p, k))
                 for r0, cb, plan, p in zip(engine.row0,
                                            engine.combined_buckets,
                                            engine.plans, engine.planes)]
        packed0 = torch.where(engine.degrees == 0, 0, 1).to(torch.int32)
        return k, packed0, 1, parts
    k_eff = clamp_budget(k, 32 * engine.num_planes)
    packed0 = torch.where(engine.degrees == 0, 0, -1).to(torch.int32)
    return k_eff, packed0, 0, [(0, engine.table, engine.plan,
                                engine.num_planes, True)]


def _k1_bytes(ctrl, state, row0: int, plan) -> int:
    """The bytes K1 must move over a part's rows on this state: the new
    word of each row written; for each row that is not confirmed, its real
    length and its real entries (``plan.lens``, the sentinel padding past
    them is not needed work); the state words the rows and those entries
    name read once (at most the state). None for a launch past the
    attempt's end."""
    from dgc_tpu_torch.kernels import superstep as ks

    c = ctrl.tolist()
    if c[ks.CTRL_STATUS] != 0:
        return 0
    rows = plan.lens.shape[0]
    words = state[c[ks.CTRL_CUR], row0: row0 + rows]
    live = ~((words >= 0) & (words & 1 == 0))
    real = int(plan.lens[live].sum())
    return 4 * (rows + int(live.sum()) + real
                + min(rows + real, state.shape[1]))


class _HeldK1:
    """While installed, every K1 launch runs its plain version on copies
    first and the kernel on the engine's tensors, keeps the largest
    difference, the launches and the bytes they needed (``_k1_bytes``),
    and the plain versions' host time."""

    def __init__(self):
        from dgc_tpu_torch.kernels import superstep as ks

        self.ks, self.real = ks, ks.superstep_rows
        self.err = self.calls = self.bytes = 0
        self.plain_s = 0.0

    def __enter__(self):
        self.ks.superstep_rows = self
        return self

    def __exit__(self, *exc):
        self.ks.superstep_rows = self.real

    def __call__(self, ctrl, state, table, row0, planes, k, fv, plan):
        self.bytes += _k1_bytes(ctrl, state, row0, plan)
        c_p, s_p = ctrl.clone(), state.clone()
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.ks.superstep_rows_reference(c_p, s_p, table, row0, planes, k,
                                         fv, plan)
        torch.cuda.synchronize()
        self.plain_s += time.perf_counter() - t
        self.real(ctrl, state, table, row0, planes, k, fv, plan)
        self.err = max(self.err, _diff(state, s_p), _diff(ctrl, c_p))
        self.calls += 1


def _k1_by_bucket(k: int, parts, packed0, step0: int) -> list[dict]:
    """K1 on each part alone at a fresh attempt's first superstep (every
    row with a neighbor active), timed over repeated launches (each redoes
    the same step), beside its bound (``_k1_bytes``)."""
    from dgc_tpu_torch.kernels import superstep as ks

    v = packed0.shape[0]
    out = []
    for row0, table, plan, planes, fv in parts:
        ctrl = ks.new_ctrl(step0, v + 1, packed0.device)
        state = ks.new_state(packed0)
        nbytes = _k1_bytes(ctrl, state, row0, plan)
        out.append({
            "width": table.shape[1], "rows": table.shape[0],
            "real_entries": int(plan.lens.sum()),
            "team": "block" if plan.block else f"{plan.lanes} lanes",
            "ms": _device_ms(lambda: ks.superstep_rows(
                ctrl, state, table, row0, planes, k, fv, plan), 10,
                "superstep_rows"),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    return out


def _k1_sweep(engine, ks_swept: list[int]) -> dict:
    """The main path's attempts (at the budgets ``ks_swept``, in order)
    replayed with every K1 launch held against its plain version, then
    again under the profiler: K1's device time summed over the same
    launches, beside the bound over them (``_k1_bytes`` at each launch's
    state) and the plain versions' time."""
    with _HeldK1() as held:
        for k in ks_swept:
            engine.attempt(k)
    check(held.err == 0, f"K1 disagrees with its plain version over the "
                         f"replayed sweep: max abs err {held.err}")
    prof = _profiled(lambda: [engine.attempt(k) for k in ks_swept],
                     {"superstep_rows": held.calls},
                     names={"superstep_rows": "superstep_rows"})
    total, n, each = prof["superstep_rows"]
    return {"k1_sweep_ms": total, "k1_sweep_launches": n,
            "k1_sweep_max_launch_ms": max(each) if each else None,
            "k1_sweep_bound_ms": held.bytes / HBM_BYTES_PER_S * 1e3,
            "k1_sweep_bytes": held.bytes,
            "k1_sweep_plain_ms": held.plain_s * 1e3,
            "k1_sweep_held_err": held.err}


def measure_kernels(engine, k: int, directed_edges: int) -> dict:
    """Time K1 (one superstep: every part) and K2 at the engine's shapes,
    hold K1 against its plain version on the first superstep and on a
    mid-attempt state, and compute the bound."""
    from dgc_tpu_torch.kernels import superstep as ks
    from dgc_tpu_torch.ops.speculative import NBR_MASK

    k_run, packed0, step0, parts = _engine_parts(engine, k)
    v = packed0.shape[0]

    def fresh():
        return (ks.new_ctrl(step0, v + 1, packed0.device),
                ks.new_state(packed0))

    def k1(ctrl, state, fn=ks.superstep_rows):
        for row0, table, plan, planes, fv in parts:
            fn(ctrl, state, table, row0, planes, k_run, fv, plan)

    err = 0
    for steps in (0, 3):  # the first superstep, then a mid-attempt one
        ctrl, state = fresh()
        for _ in range(steps):
            k1(ctrl, state)
            ks.superstep_finish(ctrl, ks.INT32_MAX, 64)
        ctrl_p, state_p = ctrl.clone(), state.clone()
        k1(ctrl, state)
        k1(ctrl_p, state_p, ks.superstep_rows_reference)
        torch.cuda.synchronize()
        err = max(err, int((state - state_p).abs().max()),
                  int((ctrl - ctrl_p).abs().max()))
    check(err == 0, f"K1 disagrees with its plain version at the main "
                    f"path's shapes: max abs err {err}")

    ctrl, state = fresh()
    k1_ms = _cuda_ms(lambda: k1(ctrl, state), reps=50)
    k1_device_ms = _device_ms(lambda: k1(ctrl, state), reps=20,
                              name="superstep_rows", per_call=len(parts))
    ctrl, state = fresh()
    k1_plain_ms = _host_ms(
        lambda: k1(ctrl, state, ks.superstep_rows_reference), reps=3)
    ctrl, _ = fresh()
    k2_ms = _cuda_ms(lambda: ks.superstep_finish(ctrl, ks.INT32_MAX, 64),
                     reps=200)
    k2_device_ms = _device_ms(
        lambda: ks.superstep_finish(ctrl, ks.INT32_MAX, 64), reps=50,
        name="superstep_finish_kernel")
    ctrl, _ = fresh()
    k2_plain_ms = _host_ms(
        lambda: ks.superstep_finish_reference(ctrl, ks.INT32_MAX, 64), reps=50)
    # K2 folding a running step (the control block reset before each
    # launch, so none returns early), without and with the row write (B11)
    from dgc_tpu_torch.obs.kernel import traj_cap_for, traj_empty

    running, _ = fresh()
    running[ks.CTRL_ACTIVE] = v // 2
    ctrl = running.clone()
    traj = traj_empty(traj_cap_for(engine.max_steps), device=packed0.device)
    gcalls = len(parts) if step0 else -1

    def k2(rec=False, fn=ks.superstep_finish):
        ctrl.copy_(running)
        fn(ctrl, ks.INT32_MAX, 64, *((traj, gcalls) if rec else ()))

    k2_fold_ms = _device_ms(k2, 50, "superstep_finish_kernel")
    k2_rec_ms = _device_ms(lambda: k2(True), 50, "superstep_finish_kernel")
    k2_rec_plain_ms = _host_ms(
        lambda: k2(True, ks.superstep_finish_reference), reps=50)
    # yardstick only (the port never calls it): one torch gather of the
    # state through every table entry
    src = state[0]
    masks = [(t & NBR_MASK).to(torch.int64) for _, t, _, _, _ in parts]
    gather_ms = _cuda_ms(lambda: [src[m] for m in masks], reps=20)

    # The bound counts what a superstep needs (_k1_bytes): each row's word
    # read and written, and each row that is not confirmed its length, its
    # real entries (the sentinel padding past its degree is not needed
    # work) and the state words they name. The timed calls all run a first
    # superstep, where every vertex with a neighbor is uncolored (ELL) or
    # fresh (bucketed) and reads its whole list. The padded tables' bytes
    # are kept beside it.
    entries = sum(int(t.numel()) for _, t, _, _, _ in parts)
    real = sum(int(((t & NBR_MASK) != v).sum()) for _, t, _, _, _ in parts)
    check(real == directed_edges, f"tables hold {real} real entries, the "
                                  f"graph {directed_edges} directed edges")
    check(real == sum(int(plan.lens.sum()) for _, _, plan, _, _ in parts),
          "the plans' lengths do not hold every real entry once")
    ctrl, state = fresh()
    k1_bytes = sum(_k1_bytes(ctrl, state, row0, plan)
                   for row0, _, plan, _, _ in parts) + 8 * 4
    table_bytes = entries * 4 + 2 * v * 4 + 8 * 4
    # one whole attempt: host wall clock against the device's busy time
    t = time.perf_counter()
    engine.attempt(k)
    attempt_wall_ms = (time.perf_counter() - t) * 1e3
    attempt_device_ms = _device_ms(lambda: engine.attempt(k), reps=1)
    by_bucket = (_k1_by_bucket(k_run, parts, packed0, step0)
                 if len(parts) > 1 else None)
    return {
        "k1_by_bucket": by_bucket,
        "k1_ms": k1_device_ms, "k1_event_ms": k1_ms,
        "k1_plain_ms": k1_plain_ms,
        "k1_bound_ms": k1_bytes / HBM_BYTES_PER_S * 1e3,
        "k1_bytes": k1_bytes, "real_entries": real,
        "table_entries": entries, "k1_table_bytes": table_bytes,
        "k1_table_bound_ms": table_bytes / HBM_BYTES_PER_S * 1e3,
        "k1_launches_per_superstep": len(parts),
        "k2_ms": k2_device_ms, "k2_event_ms": k2_ms,
        "k2_plain_ms": k2_plain_ms,
        "attempt_k": k, "attempt_wall_ms": attempt_wall_ms,
        "attempt_device_busy_ms": attempt_device_ms,
        "k2_bound_ms": 2 * 8 * 4 / HBM_BYTES_PER_S * 1e3,
        "k2_fold_ms": k2_fold_ms, "k2_rec_ms": k2_rec_ms,
        "k2_rec_plain_ms": k2_rec_plain_ms,
        # the control block read and written, the row of 6 words written
        "k2_rec_bound_ms": (2 * 8 + 6) * 4 / HBM_BYTES_PER_S * 1e3,
        "gather_yardstick_ms": gather_ms, "max_abs_err": err,
    }


_COMPACT_KERNELS = ("compact_slots", "stage_rows", "segmented_superstep",
                    "stage_finish")
_HUB_KERNELS = ("hub_slots", "hub_superstep")


def _active_words(words: torch.Tensor) -> torch.Tensor:
    return (words < 0) | ((words & 1) == 1)


def _k5_bytes(src, seg, plan, gidx, row_base: int, v: int) -> int:
    """The bytes one K5 superstep needs from this data: the real entries of
    its active rows, each state word it reads once (those entries'
    neighbors and every row's own word), each active row written, and the
    slot list."""
    from dgc_tpu_torch.ops.segmented_gather import plan_rows
    from dgc_tpu_torch.ops.speculative import NBR_MASK

    dev = seg.device
    if gidx is None:
        own = torch.arange(row_base, row_base + plan_rows(plan), device=dev)
    else:
        own = gidx.to(torch.int64)
    real_row = own != v + 1
    act = _active_words(src[own]) & real_row
    row_of = torch.cat([torch.arange(s_.row0, s_.row0 + s_.rows, device=dev)
                        .repeat_interleave(s_.width) for s_ in plan])
    ids = (seg & NBR_MASK).to(torch.int64)
    need = act[row_of] & (ids != v)
    words = int(torch.unique(torch.cat([ids[need], own[real_row]])).numel())
    slots = 0 if gidx is None else int(own.numel())
    return 4 * (int(need.sum()) + words + int(act.sum()) + slots)


def _hub_rows(b, branch: int, src, table, pool, v: int):
    """(row indices, their entries, conf planes read) of bucket ``b`` on
    ``branch``, after K7: the rows K8 reads for it."""
    from dgc_tpu_torch.engine import hub as th

    dev = src.device
    cb = table[b.cb: b.cb + b.rows * b.width].view(b.rows, b.width)
    if branch == th.BRANCH_FULL:
        return torch.arange(b.rows, device=dev), cb, False
    if branch in (th.BRANCH_COMPACT, th.BRANCH_REBASE):
        idx = pool[b.slots: b.slots + b.pad].to(torch.int64)
        real = idx < b.rows
        return idx[real], cb[idx[real]], False
    t2 = branch == th.BRANCH_PRUNED2
    n = b.p2 if t2 else b.pad
    slots = pool[(b.slots2 if t2 else b.slots1):][:n].to(torch.int64)
    comb = pool[(b.comb2 if t2 else b.comb1):][: n * b.u].view(n, b.u)
    if branch == th.BRANCH_SHRINK:
        sel = pool[b.sel: b.sel + b.p2].to(torch.int64)
        sel = sel[sel < b.pad]
        slots, comb = slots[sel], comb[sel]
    real = slots < b.rows
    return slots[real], comb[real], True


def _k8_bytes(src, table, live, plan, pool, v: int) -> int:
    """The bytes one K8 launch needs from this data, after K7 chose the
    branches: the entries of the rows each branch must evaluate (its active
    rows; every slot of a rebase, for the capture), each state word read
    once, each evaluated row written, the slot lists and captured planes
    read, and the captures written."""
    from dgc_tpu_torch.engine import hub as th
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.ops.speculative import NBR_MASK

    ids_all, own_all = [], []
    count = 0
    for bi, b in enumerate(plan.buckets):
        branch = int(live[kc.LIVE_BRANCH, bi])
        if branch == th.BRANCH_SKIP:
            continue
        idx, ent, seeded = _hub_rows(b, branch, src, table, pool, v)
        own = b.row0 + idx
        act = (torch.ones_like(own, dtype=torch.bool)
               if branch == th.BRANCH_REBASE else _active_words(src[own]))
        ids = (ent & NBR_MASK).to(torch.int64)
        need = act[:, None] & (ids != v)
        ids_all.append(ids[need])
        own_all.append(own)
        count += int(need.sum()) + int(act.sum())
        if branch != th.BRANCH_FULL:
            count += b.p2 if branch in (th.BRANCH_SHRINK,
                                        th.BRANCH_PRUNED2) else b.pad
        if seeded:
            count += int(act.sum()) * b.planes
        if branch == th.BRANCH_REBASE:
            count += b.pad * (b.u + b.planes)
        elif branch == th.BRANCH_SHRINK:
            count += b.p2 * (1 + b.u + b.planes)
    if own_all:
        count += int(torch.unique(torch.cat(ids_all + own_all)).numel())
    return 4 * count


def _k7_bytes(live, plan) -> int:
    """K7 reads and copies every hub row's word, reads the live counts and
    tiers, writes the branch and staged rows and the slot lists."""
    from dgc_tpu_torch.engine import hub as th
    from dgc_tpu_torch.kernels import compact as kc

    count = 0
    for bi, b in enumerate(plan.buckets):
        branch = int(live[kc.LIVE_BRANCH, bi])
        count += 2 * b.rows + 5
        if branch in (th.BRANCH_COMPACT, th.BRANCH_REBASE):
            count += b.pad
        elif branch == th.BRANCH_SHRINK:
            count += b.pad + b.p2
    return 4 * count


class _HeldCompactKernels:
    """A test double over the compact engine's kernel wrappers
    (``kernels.compact`` K3-K6 and ``kernels.hub`` K7-K8). While installed,
    every call runs the plain version on copies of what the kernel reads
    and moves, then the kernel on the engine's own tensors, and keeps the
    largest difference, the bytes the call needed (``_k5_bytes`` and the
    like; zero for a call past its stage's end), the plain versions' host
    time, and which branch each hub bucket took. It also keeps each stage's
    inputs for timing: a stage begins at a K3 call (a compaction stage) or
    at a K5 call on another table or control block than the open stage's
    (the full-table phase); an attempt begins at a new control block. K5's
    and K6's inputs are those of the stage's first superstep. The engine
    runs unchanged and its launches count as usual, so it is installed
    only outside a run whose counts are read."""

    def __init__(self):
        from dgc_tpu_torch.kernels import compact as kc
        from dgc_tpu_torch.kernels import hub as kh

        self.kc, self.kh = kc, kh
        self.mods = {**dict.fromkeys(_COMPACT_KERNELS, kc),
                     **dict.fromkeys(_HUB_KERNELS, kh)}
        self.real = {name: getattr(mod, name) for name, mod in self.mods.items()}
        self.err = 0
        self.calls = dict.fromkeys(self.real, 0)
        self.bytes: dict[int, dict[str, int]] = {}  # attempt -> kernel -> B
        self.plain_s = dict.fromkeys(self.real, 0.0)
        self.branches: dict[int, dict[str, int]] = {}  # bucket -> branch -> n
        self.stages: list[dict] = []
        self.attempts = 0
        self._ctrl = None  # the open attempt's control block
        self.k5_kinds: list[str] = []  # "full" or "stage", in call order

    def __enter__(self):
        for name, mod in self.mods.items():
            setattr(mod, name, getattr(self, name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.mods[name], name, fn)

    def _held(self, *pairs) -> None:
        for a, b in pairs:
            self.err = max(self.err, _diff(a, b))

    def _plain(self, name: str, fn, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        self.plain_s[name] += time.perf_counter() - t
        return out

    def _attempt(self, ctrl) -> int:
        if ctrl is not self._ctrl:
            self._ctrl = ctrl
            self.attempts += 1
            self.bytes[self.attempts - 1] = dict.fromkeys(self.real, 0)
        return self.attempts - 1

    def _count(self, ctrl, name: str, nbytes: int) -> None:
        self.calls[name] += 1
        self.bytes[self._attempt(ctrl)][name] += nbytes

    def _open(self, ctrl, pad, seg=None) -> dict:
        attempt = self._attempt(ctrl)
        c = ctrl.tolist()
        self.stages.append({"attempt": attempt, "pad": pad,
                            "seg": seg, "steps": 0,
                            "entry_step": c[self.kc.CTRL_STEP],
                            "entry_active": c[self.kc.CTRL_PREV_ACTIVE]})
        return self.stages[-1]

    def compact_slots(self, ctrl, state, row0, pad, scratch=None):
        stage = self._open(ctrl, pad)
        self._count(ctrl, "compact_slots", 4 * (2 * (state.shape[1] - 2 - row0)
                                                + pad))
        c_p, s_p = ctrl.clone(), state.clone()
        stage["k3"] = (c_p.clone(), s_p.clone(), row0, pad, scratch)
        idx_p = self._plain("compact_slots", self.kc.compact_slots_reference,
                            c_p, s_p, row0, pad)
        idx = self.real["compact_slots"](ctrl, state, row0, pad, scratch)
        self._held((idx, idx_p), (state, s_p), (ctrl, c_p))
        return idx

    def stage_rows(self, flat_ext, idx, plan, desc, row0, v):
        seg, gidx = self.real["stage_rows"](flat_ext, idx, plan, desc, row0, v)
        self._count(self._ctrl, "stage_rows",
                    4 * (2 * idx.numel() + 2 * seg.numel()))
        seg_p, gidx_p = self._plain("stage_rows", self.kc.stage_rows_reference,
                                    flat_ext, idx, plan, row0, v)
        self._held((seg, seg_p), (gidx, gidx_p))
        self.stages[-1].update(seg=seg, k4=(flat_ext, idx, plan, desc, row0, v))
        return seg, gidx

    def segmented_superstep(self, ctrl, state, seg, plan, desc, k, thresh,
                            max_steps, gidx=None, row_base=0, umax=None,
                            ucol=0):
        self.k5_kinds.append("full" if gidx is None else "stage")
        stage = self.stages[-1] if self.stages else None
        if stage is None or stage["seg"] is not seg or ctrl is not self._ctrl:
            stage = self._open(ctrl, None, seg)  # the full-table phase
        c_p, s_p = ctrl.clone(), state.clone()
        live = self.kc.stage_live(ctrl.tolist(), thresh, max_steps)
        v = state.shape[1] - 2
        self._count(ctrl, "segmented_superstep", _k5_bytes(
            state[int(c_p[self.kc.CTRL_CUR])], seg, plan, gidx, row_base, v)
            if live else 0)
        if live:
            stage["steps"] += 1
            if "k5" not in stage:
                stage["k5"] = (c_p.clone(), s_p.clone(), seg, plan, desc, k,
                               thresh, max_steps, gidx, row_base)
        u_p = None if umax is None else umax.clone()
        self._plain("segmented_superstep",
                    self.kc.segmented_superstep_reference, c_p, s_p, seg,
                    plan, k, thresh, max_steps, gidx=gidx, row_base=row_base,
                    umax=u_p, ucol=ucol)
        self.real["segmented_superstep"](ctrl, state, seg, plan, desc, k,
                                         thresh, max_steps, gidx=gidx,
                                         row_base=row_base, umax=umax,
                                         ucol=ucol)
        self._held((state, s_p), (ctrl, c_p),
                   *(() if umax is None else ((umax, u_p),)))

    def stage_finish(self, ctrl, state, ring, live, hub_buckets, thresh,
                     max_steps, stall_window, record, tel=None):
        kc = self.kc
        stage = self.stages[-1]
        c = ctrl.tolist()
        nbytes = 0
        if kc.stage_live(c, thresh, max_steps):
            nb = live.shape[1]
            push = (record and c[kc.CTRL_FAIL] == 0
                    and c[kc.CTRL_MC] > c[kc.CTRL_REC_BEST])
            nbytes = 4 * (2 * kc.CTRL_LEN + 4 * nb
                          + (2 * (state.shape[1] + nb) + kc.META_COLS
                             if push else 0))
        self._count(ctrl, "stage_finish", nbytes)
        c_p, s_p, l_p = ctrl.clone(), state.clone(), live.clone()
        r_p = None if ring is None else tuple(t.clone() for t in ring)
        if "k6" not in stage and "k5" in stage:
            stage["k6"] = (c_p.clone(), s_p.clone(), l_p.clone(), hub_buckets,
                           thresh, max_steps, stall_window)
        t_p = None if tel is None else tel._replace(
            traj=tel.traj.clone(), umax=tel.umax.clone())
        self._plain("stage_finish", kc.stage_finish_reference, c_p, s_p, r_p,
                    l_p, hub_buckets, thresh, max_steps, stall_window, record,
                    tel=t_p)
        self.real["stage_finish"](ctrl, state, ring, live, hub_buckets, thresh,
                                  max_steps, stall_window, record, tel=tel)
        self._held((ctrl, c_p), (state, s_p), (live, l_p),
                   *(() if ring is None else zip(ring, r_p)),
                   *(() if tel is None else ((tel.umax, t_p.umax),)))
        if tel is not None:
            self.err = max(self.err, _traj_diff(tel.traj, t_p.traj,
                                                tel.timing))

    def hub_slots(self, ctrl, state, live, plan, pool, thresh, max_steps):
        from dgc_tpu_torch.engine.hub import BRANCH_NAMES

        c_p, s_p, l_p, p_p = (t.clone() for t in (ctrl, state, live, pool))
        self._plain("hub_slots", self.kh.hub_slots_reference, c_p, s_p, l_p,
                    plan, p_p, thresh, max_steps)
        live_step = self.kc.stage_live(ctrl.tolist(), thresh, max_steps)
        self._count(ctrl, "hub_slots", _k7_bytes(l_p, plan) if live_step else 0)
        if live_step:
            for bi, br in enumerate(l_p[self.kc.LIVE_BRANCH,
                                        :len(plan.buckets)].tolist()):
                seen = self.branches.setdefault(bi, {})
                seen[BRANCH_NAMES[br]] = seen.get(BRANCH_NAMES[br], 0) + 1
        self.real["hub_slots"](ctrl, state, live, plan, pool, thresh, max_steps)
        self._held((ctrl, c_p), (state, s_p), (live, l_p), (pool, p_p))

    def hub_superstep(self, ctrl, state, table, live, plan, pool, k, thresh,
                      max_steps, umax=None):
        c_p, s_p, l_p, p_p = (t.clone() for t in (ctrl, state, live, pool))
        u_p = None if umax is None else umax.clone()
        live_step = self.kc.stage_live(ctrl.tolist(), thresh, max_steps)
        nbytes = _k8_bytes(state[int(c_p[self.kc.CTRL_CUR])], table, live,
                           plan, pool, state.shape[1] - 2) if live_step else 0
        self._count(ctrl, "hub_superstep", nbytes)
        self._plain("hub_superstep", self.kh.hub_superstep_reference, c_p,
                    s_p, table, l_p, plan, p_p, k, thresh, max_steps,
                    umax=u_p)
        self.real["hub_superstep"](ctrl, state, table, live, plan, pool, k,
                                   thresh, max_steps, umax=umax)
        self._held((ctrl, c_p), (state, s_p), (live, l_p), (pool, p_p),
                   *(() if umax is None else ((umax, u_p),)))


K3_REPLAYS = 50


def _k3_replays(ctrl, state, row0: int, pad: int, scratch) -> int:
    """K3 replayed ``K3_REPLAYS`` times on one stage's kept inputs and
    scratch, each launch held against the plain version (the slot list and
    both buffers): an epoch or flag race shows as a mismatch. Returns the
    launches held."""
    from dgc_tpu_torch.kernels import compact as kc

    s_p = state.clone()
    idx_p = kc.compact_slots_reference(ctrl.clone(), s_p, row0, pad)
    worst = 0
    for _ in range(K3_REPLAYS):
        got = state.clone()
        worst = max(worst, _diff(kc.compact_slots(ctrl, got, row0, pad,
                                                  scratch), idx_p),
                    _diff(got, s_p))
    check(worst == 0, f"K3 replayed on a stage's inputs differs from its "
                      f"plain version by {worst}")
    return K3_REPLAYS


def _time_stage(stage: dict, v: int) -> dict:
    """Time K3-K6 on one stage's kept inputs (K5 and K6 at its first
    superstep), their plain versions and library calls, and compute the
    bounds from this run's data."""
    from dgc_tpu_torch.engine.bucketed import STALL_WINDOW
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.ops.segmented_gather import plan_rows
    from dgc_tpu_torch.ops.speculative import NBR_MASK

    rec = {key: stage[key] for key in ("pad", "steps", "entry_step",
                                       "entry_active")}
    if stage["pad"] is not None:
        ctrl, state, row0, pad, scratch = stage["k3"]
        flat, idx, plan, desc, row0, _ = stage["k4"]
        pk = state[int(ctrl[kc.CTRL_CUR]), row0:v]
        act = (pk < 0) | ((pk & 1) == 1)
        rows = idx.to(torch.int64)
        total = int(stage["seg"].numel())
        # K3 reads V words, copies them, writes the slot list; K4 reads the
        # slot list and the entries, writes them and the indices
        k3_bytes = (2 * (v - row0) + pad) * 4
        k4_bytes = (2 * pad + 2 * total) * 4
        rec.update({
            "ranges": [list(s_) for s_ in plan], "stage_entries": total,
            "k3_replays_held": _k3_replays(ctrl, state, row0, pad, scratch),
            "k3_ms": _device_ms(lambda: kc.compact_slots(ctrl, state, row0,
                                                         pad, scratch),
                                20, "compact_slots_kernel"),
            "k3_plain_ms": _host_ms(lambda: kc.compact_slots_reference(
                ctrl, state, row0, pad), 3),
            "k3_library_ms": _device_ms(lambda: torch.nonzero(act), 20),
            "k3_bound_ms": k3_bytes / HBM_BYTES_PER_S * 1e3,
            "k3_bytes": k3_bytes,
            "k4_ms": _device_ms(lambda: kc.stage_rows(
                flat, idx, plan, desc, row0, v), 20, "stage_rows_kernel"),
            "k4_plain_ms": _host_ms(lambda: kc.stage_rows_reference(
                flat, idx, plan, row0, v), 3),
            "k4_library_ms": _device_ms(lambda: torch.cat([
                flat[rows[s_.row0: s_.row0 + s_.rows], : s_.width]
                .reshape(-1) for s_ in plan]), 20),
            "k4_bound_ms": k4_bytes / HBM_BYTES_PER_S * 1e3,
            "k4_bytes": k4_bytes,
        })
    # K5 from its first superstep's inputs; repeated calls redo the same
    # step (the predicate's slots do not move)
    ctrl, state, seg, plan, desc, k, thresh, max_steps, gidx, row_base = \
        stage["k5"]

    umax = torch.zeros(1, dtype=torch.int32, device=seg.device)

    def k5(fn=kc.segmented_superstep, with_desc=True, rec=False):
        extra = (desc,) if with_desc else ()
        fn(ctrl, state, seg, plan, *extra, k, thresh, max_steps, gidx=gidx,
           row_base=row_base, umax=umax if rec else None)

    ids = seg & NBR_MASK
    real = ids != v
    if gidx is None:
        own = torch.arange(row_base, row_base + plan_rows(plan),
                           dtype=torch.int32, device=seg.device)
    else:
        own = gidx[gidx != v + 1]
    # the real entries of the evaluated rows; each state word the step
    # reads (the union of the gathered ids and the rows' own) once; each
    # row written once; the slot list
    n_real = int(real.sum())
    words = int(torch.unique(torch.cat([ids[real], own])).numel())
    slots = 0 if gidx is None else int(gidx.numel())
    k5_bytes = 4 * (n_real + words + int(own.numel()) + slots)
    src = state[int(ctrl[kc.CTRL_CUR])]
    ids64 = ids.to(torch.int64)
    # K6 from the first superstep's counters: a push (a new mc best, the
    # state copied into the ring) and a launch that does not record
    counted, state6, live6, nh, thresh, max_steps, window = stage["k6"]
    pushed = counted.clone()
    pushed[kc.CTRL_REC_BEST] = -1
    cc = pushed.clone()
    nb = live6.shape[1]
    ring = kc.new_ring(v, nb, seg.device)
    k6_push_bytes = 4 * (2 * (v + 2 + nb) + 2 * kc.CTRL_LEN + kc.META_COLS
                         + 4 * nb)
    # the recording K6 (B11) on the same counters, its clock on: one row
    # of 6 + 2·nb words written, the unconf vector read and cleared, the
    # gather-call weights read
    from dgc_tpu_torch.obs.kernel import traj_cap_for, traj_empty

    tel = kc.Telemetry(traj_empty(traj_cap_for(2 * v + 4), nb, unconf_b=True,
                                  device=seg.device),
                       torch.zeros(nb, dtype=torch.int32, device=seg.device),
                       torch.ones(nb, dtype=torch.int32, device=seg.device),
                       0, True)
    row_bytes = 4 * (kc.TRAJ_COLS + 2 * nb + 3 * nb)

    def k6(rec=False, fn=kc.stage_finish):
        cc.copy_(counted)
        fn(cc, state6, None, live6.clone(), nh, thresh, max_steps, window,
           False, tel=tel if rec else None)

    rec.update({
        "k5_rows": int(own.numel()), "k5_entries": int(seg.numel()),
        "k5_real_entries": n_real, "k5_state_words": words,
        "k5_ms": _device_ms(k5, 20, "segmented_superstep_kernel"),
        "k5_plain_ms": _host_ms(lambda: k5(
            kc.segmented_superstep_reference, False), 3),
        "k5_bound_ms": k5_bytes / HBM_BYTES_PER_S * 1e3,
        "k5_bytes": k5_bytes,
        "k5_gather_yardstick_ms": _device_ms(lambda: src[ids64], 20),
        "k6_push_ms": _device_ms(lambda: (cc.copy_(pushed), kc.stage_finish(
            cc, state6, ring, live6.clone(), nh, thresh, max_steps, window,
            True)), 20, "stage_finish_kernel"),
        "k6_ms": _device_ms(lambda: (cc.copy_(counted), kc.stage_finish(
            cc, state6, None, live6.clone(), nh, thresh, max_steps, window,
            False)), 20, "stage_finish_kernel"),
        "k6_plain_ms": _host_ms(lambda: (cc.copy_(pushed),
                                         kc.stage_finish_reference(
            cc, state6, ring, live6.clone(), nh, thresh, max_steps, window,
            True)), 5),
        "k6_push_bound_ms": k6_push_bytes / HBM_BYTES_PER_S * 1e3,
        "k5_rec_ms": _device_ms(lambda: k5(rec=True), 20,
                                "segmented_superstep_kernel"),
        "k5_rec_plain_ms": _host_ms(lambda: k5(
            kc.segmented_superstep_reference, False, True), 3),
        "k5_rec_bound_ms": (k5_bytes + 8) / HBM_BYTES_PER_S * 1e3,
        "k6_rec_ms": _device_ms(lambda: k6(True), 20, "stage_finish_kernel"),
        "k6_rec_plain_ms": _host_ms(lambda: k6(
            True, kc.stage_finish_reference), 5),
        "k6_rec_bound_ms": (4 * (2 * kc.CTRL_LEN + 4 * nb) + row_bytes)
        / HBM_BYTES_PER_S * 1e3,
        "k6_row_bytes": row_bytes,
        "k6_bound_ms": 4 * (2 * kc.CTRL_LEN + 4 * nb) / HBM_BYTES_PER_S * 1e3,
        "k6_push_bytes": k6_push_bytes,
    })
    check(window == STALL_WINDOW, f"K6 ran with stall window {window}")
    return rec


_KERNEL_NAMES = {"compact_slots": "compact_slots_kernel",
                 "stage_rows": "stage_rows_kernel",
                 "segmented_superstep": "segmented_superstep_kernel",
                 "stage_finish": "stage_finish_kernel",
                 "hub_slots": "hub_slots_kernel",
                 "hub_superstep": "hub_superstep_kernel",
                 "dense_forbid": "dense_forbid_kernel",
                 "dense_resolve": "dense_resolve_kernel"}


# a profiler window sometimes drops its first kernel records (up to ~25
# in the serve windows): each window opens with this many fill launches
# on a scratch tensor, which the readings then leave out
PROFILE_PAD = 64


def _profiled(fn, launches: dict, min_share: float = 1.0, names=None,
              prepare=None) -> dict:
    """``fn()`` under ``torch.profiler``: per kernel of ``names`` (name:
    a substring of its device events' names; default ``_KERNEL_NAMES``)
    the device time summed over its launches, their count and each
    launch's time in order (ms). The window opens with ``PROFILE_PAD``
    fills, left out of every reading; a name "" sums every other device
    event. The profile is taken again (five times at most: a long window
    now and then drops a few launch records) until it holds ``launches``
    of each (at least ``min_share`` of them, where a caller takes the
    mean over the records the profiler kept). ``prepare()``, where
    given, runs before each window, outside it, and its result is
    ``fn``'s argument."""
    from torch.profiler import ProfilerActivity, profile

    names = _KERNEL_NAMES if names is None else names
    pad = torch.empty(1, device="cuda")
    for _ in range(6):
        arg = () if prepare is None else (prepare(),)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                pad.fill_(0)
            fn(*arg)
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "FillFunctor" not in e.name]
        sums = {}
        for name, kname in names.items():
            ev = sorted((e for e in device if kname in e.name),
                        key=lambda e: e.time_range.start)
            each = [e.time_range.elapsed_us() / 1e3 for e in ev]
            sums[name] = (sum(each), len(ev), each)
        if all(min_share * c <= sums[n][1] <= c for n, c in launches.items()):
            return sums
    raise SmokeFailure(f"the profiled run showed "
                       f"{ {n: sums[n][:2] for n in sums} }, the held one "
                       f"launched {launches}")


def _k5_split(each: list, kinds: list) -> dict:
    """K5's launches of one profiled sweep (device ms, in order) split by
    kind, full table or compaction stage, from the held sweep's kinds in
    the same order: each kind's launches, sum and mean."""
    check(len(each) == len(kinds), f"the profile kept {len(each)} K5 "
                                   f"launches, the held sweep made "
                                   f"{len(kinds)}")
    out = {}
    for kind in ("full", "stage"):
        ms = [t for t, kd in zip(each, kinds) if kd == kind]
        out[kind] = {"launches": len(ms), "sum_ms": sum(ms),
                     "mean_ms": sum(ms) / len(ms) if ms else None}
    return out


def _k8_by_bucket(engine, k: int) -> list[dict]:
    """K8 on each hub bucket alone, at a fresh attempt's first superstep
    (every row with a neighbor active; the branch K7 picks there): a plan of
    that bucket over its slice of the hub table, timed over repeated
    launches (each redoes the same step), beside its bound."""
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.kernels import hub as kh

    hub = engine.hub_buckets
    cbs = engine.combined_buckets[:hub]
    v = engine.num_vertices
    out = []
    off = 0
    for bi, cb in enumerate(cbs):
        rows, width = cb.shape
        table = engine.seg_flat[off: off + rows * width]
        off += rows * width
        plan = kh.hub_plan([engine.row0[bi]], [rows], [width],
                           [engine.planes[bi]], [engine.hub_prune[bi]
                                                 if bi < len(engine.hub_prune)
                                                 else None],
                           [bi < len(engine.hub_uncond)
                            and bool(engine.hub_uncond[bi])],
                           engine.device, table=table, v=v)
        pool = kh.new_pool(plan, engine.device)
        state, ctrl, _ = engine._fresh()
        live = kc.new_live(torch.tensor([engine.init_bucket_active[bi]],
                                        dtype=torch.int32,
                                        device=engine.device))
        kh.hub_slots(ctrl, state, live, plan, pool, 0, engine.max_steps)
        nbytes = _k8_bytes(state[0], table, live, plan, pool, v)
        real = int(((table & ((1 << 30) - 1)) != v).sum())
        out.append({
            "width": width, "rows": rows, "real_entries": real,
            "branch": int(live[kc.LIVE_BRANCH, 0]),
            "mode": plan.buckets[0].mode,
            "ms": _device_ms(lambda: kh.hub_superstep(
                ctrl, state, table, live, plan, pool, k, 0, engine.max_steps),
                10, "hub_superstep_kernel"),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    return out


def measure_compact(engine, k: int, swept: list[tuple]) -> dict:
    """Run ``engine.sweep(k)`` — the main path's first engine call — with
    every K3-K8 call held against its plain version; its attempts must
    equal ``swept``'s first ones. Then ``attempt(k)`` held too. The bytes
    the calls needed give the sweep's and the attempt's bounds, and one
    more sweep under the profiler the device time of the same launches. On
    a hub-free layout K3-K6 are also timed on the first attempt's stage
    inputs; on a hub layout K7 and K8 are timed over the sweep's launches,
    and each bucket's branches are counted. Last, one attempt and one
    sweep unwrapped."""
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.kernels import hub as kh

    v = engine.num_vertices
    with _HeldCompactKernels() as held:
        pair = engine.sweep(k)
    rows = [(a.k, int(a.status), a.supersteps, a.colors_used)
            for a in pair if a is not None]
    check(rows == swept[:len(rows)], f"the held sweep({k}) gave {rows}, the "
                                     f"main path {swept[:len(rows)]}")
    with _HeldCompactKernels() as held_a:
        res = engine.attempt(k)
    check([(res.k, int(res.status), res.supersteps, res.colors_used)]
          == swept[:1], f"the held attempt({k}) differs from the main path")
    err = max(held.err, held_a.err)
    check(err == 0, f"K3-K8 disagree with their plain versions at the main "
                    f"path's shapes: max abs err {err}")
    # on a hub-free layout K3-K6 are timed on the held stage inputs
    stages = ([] if engine.hub_buckets else
              [_time_stage(s_, v) for s_ in held.stages if s_["attempt"] == 0])
    # the same sweep again, unheld, under the profiler: the device time of
    # the very launches the held sweep checked
    prof = _profiled(lambda: engine.sweep(k), held.calls)
    # with telemetry on (B11, the clock too): the held sweep holds the
    # recording K5, K6 and K8 against their plain versions (every column
    # but the clock exact), then the profiled one times them
    engine.record_trajectory = engine.record_timing = True
    try:
        with _HeldCompactKernels() as held_rec:
            pair_rec = engine.sweep(k)
        prof_rec = _profiled(lambda: engine.sweep(k), held_rec.calls)
    finally:
        engine.record_trajectory = engine.record_timing = False
    rows_rec = [(a.k, int(a.status), a.supersteps, a.colors_used)
                for a in pair_rec if a is not None]
    check(rows_rec == rows and held_rec.err == 0,
          f"the recording sweep({k}) gave {rows_rec} (max abs err "
          f"{held_rec.err}), the plain one {rows}")
    check(held_rec.calls == held.calls, f"the recording sweep launched "
                                        f"{held_rec.calls}, not {held.calls}")

    def per_kernel(h):
        return {name: sum(b[name] for b in h.bytes.values())
                for name in h.real}

    sweep_bytes, attempt_bytes = per_kernel(held), per_kernel(held_a)
    out = {"held_calls": held.calls, "held_attempt_calls": held_a.calls,
           "max_abs_err": err, "attempt_k": k,
           "sweep_bytes_by_kernel": sweep_bytes,
           "attempt_bytes_by_kernel": attempt_bytes,
           "sweep_bound_ms": sum(sweep_bytes.values()) / HBM_BYTES_PER_S * 1e3,
           "attempt_bound_ms":
               sum(attempt_bytes.values()) / HBM_BYTES_PER_S * 1e3,
           "sweep_device_ms_by_kernel": {n: t for n, (t, *_) in prof.items()},
           "plain_ms_by_kernel": {n: held.plain_s[n] * 1e3 / held.calls[n]
                                  for n in held.real if held.calls[n]},
           # per launch over the same sweep, telemetry off and on
           "per_launch_ms": {n: t / c for n, (t, c, _) in prof.items() if c},
           "per_launch_rec_ms": {n: t / c for n, (t, c, _) in prof_rec.items()
                                 if c},
           "plain_rec_ms_by_kernel": {
               n: held_rec.plain_s[n] * 1e3 / held_rec.calls[n]
               for n in held_rec.real if held_rec.calls[n]},
           "bytes_per_launch": {n: sweep_bytes[n] / held.calls[n]
                                for n in held.real if held.calls[n]},
           "max_abs_err_rec": held_rec.err}
    out["k5_split"] = _k5_split(prof["segmented_superstep"][2],
                                held.k5_kinds)
    if engine.hub_buckets:
        each = sorted(prof["hub_superstep"][2])
        out["k8_launch_ms_quantiles"] = {
            q: each[min(len(each) - 1, int(q * len(each)))]
            for q in (0.0, 0.5, 0.9, 1.0)} if each else {}
        out["k8_by_bucket"] = _k8_by_bucket(engine, k)
        for name, key in (("hub_slots", "k7"), ("hub_superstep", "k8")):
            t, n, _each = prof[name]
            out.update({f"{key}_ms": t / n, f"{key}_plain_ms":
                        held.plain_s[name] * 1e3 / n,
                        f"{key}_bound_ms": sweep_bytes[name] / n
                        / HBM_BYTES_PER_S * 1e3,
                        f"{key}_bytes_per_launch": sweep_bytes[name] / n})
        # K7's yardstick: one torch.nonzero over the hub rows' active mask
        pk = engine._fresh()[0][0, : engine.flat_row0]
        act = _active_words(pk)
        out["k7_library_ms"] = _device_ms(lambda: torch.nonzero(act), 20)
        out["branches_by_bucket"] = {
            f"{bi}: {b.rows}x{b.width} {['uncond', 'pad', 'prune'][b.kind]}"
            f"{'' if b.cfg is None else list(b.cfg)}": held.branches.get(bi, {})
            for bi, b in enumerate(engine._hub_plan.buckets)}
    else:
        full = stages[0]
        first_stage = next(r for r in stages if r["pad"] is not None)
        out.update({"stages": stages, "k3_ms": first_stage["k3_ms"],
                    "k4_ms": first_stage["k4_ms"], "k5_ms": full["k5_ms"],
                    "k6_ms": full["k6_push_ms"]})
    # one attempt and one sweep: host wall clock against device busy time
    for name, fn in (("attempt", lambda: engine.attempt(k)),
                     ("sweep", lambda: engine.sweep(k))):
        engine.host_syncs = 0
        kc.reset_launch_counts()
        kh.reset_launch_counts()
        t = time.perf_counter()
        fn()
        out[f"{name}_wall_ms"] = (time.perf_counter() - t) * 1e3
        out[f"{name}_host_syncs"] = engine.host_syncs
        out[f"{name}_launches"] = {**kc.launch_counts, **kh.launch_counts}
        out[f"{name}_device_busy_ms"] = _device_ms(fn, reps=1)
    # telemetry off and on in turns (off, on, on, off): one sweep's wall
    # time each, the clock on with the trajectories
    walls = []
    for rec in (False, True, True, False):
        engine.record_trajectory = engine.record_timing = rec
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.sweep(k)
        walls.append((time.perf_counter() - t) * 1e3)
    engine.record_trajectory = engine.record_timing = True
    out["sweep_wall_ms_off_on_on_off"] = walls
    out["sweep_device_busy_ms_rec"] = _device_ms(lambda: engine.sweep(k),
                                                 reps=1)
    engine.record_trajectory = engine.record_timing = False
    # the stage ladder alone: no copy of the colors home, no decode
    t = time.perf_counter()
    engine._run(k)
    torch.cuda.synchronize()
    out["ladder_wall_ms"] = (time.perf_counter() - t) * 1e3
    return out


class _TimedBlockEngine(_TimedSweepEngine):
    """The same for the blocked driver: one time per ``attempt_block``
    call, and every copy home of the engine's ``_read`` in that call (its
    bytes, and whether it was a whole row of V words)."""

    def __init__(self, engine):
        super().__init__(engine)
        self.blocks: list[list[tuple[int, bool]]] = []
        read, v = engine._read, engine.num_vertices

        def counted(t):
            self.blocks[-1].append((t.numel() * t.element_size(),
                                    t.numel() >= v))
            return read(t)

        engine._read = counted

    def attempt_block(self, k: int, attempts: int, **kw):
        self.blocks.append([])
        t = time.perf_counter()
        out = self.engine.attempt_block(k, attempts, **kw)
        self.seconds.append(time.perf_counter() - t)
        self.results += out.results
        return out


class _HeldBlockKernels:
    """A test double over ``kernels.block``'s wrappers: every K9 and K10
    call runs the plain version on copies, then the kernel on the engine's
    own tensors, and keeps the largest difference and the inputs of the
    first K9 call on a success and of the first K10 call that starts from
    the ring (the first K10 call when none does), for timing."""

    def __init__(self):
        from dgc_tpu_torch.kernels import block as kb

        self.kb = kb
        self.real = {n: getattr(kb, n) for n in ("block_record",
                                                 "block_start")}
        self.err = 0
        self.calls = dict.fromkeys(self.real, 0)
        self.k9 = self.k10 = None
        self.k10_hit = False

    def __enter__(self):
        for name in self.real:
            setattr(self.kb, name, getattr(self, name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.kb, name, fn)

    def block_record(self, ctrl, state, blk, best_pe, k_min, strict,
                     traj=None, tstack=None):
        from dgc_tpu_torch.kernels.compact import CTRL_STATUS

        self.calls["block_record"] += 1
        rec = () if traj is None else (traj, tstack)
        held = [t.clone() for t in (ctrl, state, blk, best_pe, *rec)]
        if self.k9 is None and int(ctrl[CTRL_STATUS]) == 1:
            self.k9 = [t.clone() for t in held[:4]] + [k_min, strict]
        self.kb.block_record_reference(*held[:4], k_min, strict,
                                       *(held[4:] if rec else (None, None)))
        self.real["block_record"](ctrl, state, blk, best_pe, k_min, strict,
                                  traj=traj, tstack=tstack)
        for a, b in zip((ctrl, state, blk, best_pe, *rec), held):
            self.err = max(self.err, _diff(a, b))

    def block_start(self, ctrl, blk, state, live, ring, degrees, init_ba,
                    traj=None):
        kb = self.kb
        self.calls["block_start"] += 1
        rec = () if traj is None else (traj,)
        held = [t.clone() for t in (ctrl, blk, state, live, *rec)]
        b, cnt = blk.tolist(), int(ctrl[kb.CTRL_REC_CNT])
        hit = kb.block_open(b) and any(
            j < cnt and m[1] < b[kb.BLK_K] <= m[2]
            for j, m in enumerate(ring[2].tolist()))
        if self.k10 is None or (hit and not self.k10_hit):
            self.k10_hit = hit  # a start from the ring is kept if any
            self.k10 = ([t.clone() for t in held[:4]]
                        + [tuple(t.clone() for t in ring), degrees, init_ba])
        self.kb.block_start_reference(*held[:4], ring, degrees, init_ba,
                                      held[4] if rec else None)
        self.real["block_start"](ctrl, blk, state, live, ring, degrees,
                                 init_ba, traj=traj)
        for a, b in zip((ctrl, blk, state, live, *rec), held):
            self.err = max(self.err, _diff(a, b))


def measure_block(engine, k: int, strict: bool, swept: list[tuple]) -> dict:
    """One block of 4 at ``k`` with every K9 and K10 call held against its
    plain version (the held block's attempts must equal the start of
    ``swept``); then K9 (on a success: the reduce and the best-row copy)
    and K10 timed on the held inputs (warm, and cold: the L2 cache evicted
    before each launch), their plain versions, library calls
    (``torch.amax`` and ``copy_``; one ``copy_`` of the row into both
    buffers) and byte bounds."""
    from dgc_tpu_torch.kernels import block as kb

    with _HeldBlockKernels() as held:
        out = engine.attempt_block(k, 4, strict_decrement=strict)
    rows = [(a.k, int(a.status), a.supersteps, a.colors_used)
            for a in out.results]
    check(rows == swept[:len(rows)], f"the held block at {k} gave {rows}, "
                                     f"the sweep {swept[:len(rows)]}")
    check(held.err == 0, f"K9/K10 disagree with their plain versions at the "
                         f"main path's shapes: max abs err {held.err}")
    check(held.k9 is not None, "the held block recorded no success")
    ctrl, state, blk0, best, k_min, strict_ = held.k9
    blk = blk0.clone()
    v = state.shape[1] - 2
    pe = state[int(ctrl[kb.CTRL_CUR])]
    k9_bytes = 4 * 2 * (v + 2)  # the state read, the best row written
    c10, b10, s10, l10, ring, degrees, init_ba = held.k10
    hit = held.k10_hit
    # a ring row (or the degrees) read, two state rows and the live table
    # written
    k10_bytes = 4 * ((v + 2 if hit else v) + 2 * (v + 2)
                     + kb.LIVE_ROWS * l10.shape[1])
    src = ring[0][0]
    # 64 MB written between launches evicts the 50 MB L2: the cold times
    flush = torch.empty(16 << 20, dtype=torch.int32, device=state.device)
    # the recording K9 and K10 (B11) on the same inputs: an attempt's
    # buffer (the engine's cap and row width) copied into its slot of a
    # stack of 4, and emptied
    from dgc_tpu_torch.obs.kernel import traj_cap_for, traj_empty

    traj = traj_empty(traj_cap_for(engine.max_steps),
                      len(engine.init_bucket_active), unconf_b=True,
                      device=state.device)
    tstack = torch.full((4, *traj.shape), -1, dtype=torch.int32,
                        device=state.device)
    tw = traj.numel()
    return {
        "traj_words": tw,
        "k9_rec_ms": _device_ms(lambda: (blk.copy_(blk0), kb.block_record(
            ctrl, state, blk, best, k_min, strict_, traj=traj,
            tstack=tstack)), 20, "block_record_kernel"),
        "k9_rec_plain_ms": _host_ms(lambda: (blk.copy_(blk0),
                                             kb.block_record_reference(
            ctrl, state, blk, best, k_min, strict_, traj=traj,
            tstack=tstack)), 5),
        "k9_rec_library_ms": _device_ms(lambda: (
            torch.amax(pe[:v]), best.copy_(pe), tstack[0].copy_(traj)), 20),
        "k9_rec_bound_ms": (k9_bytes + 8 * tw) / HBM_BYTES_PER_S * 1e3,
        "k10_rec_ms": _device_ms(lambda: kb.block_start(
            c10, b10, s10, l10, ring, degrees, init_ba, traj=traj), 20,
            "block_start_kernel"),
        "k10_rec_plain_ms": _host_ms(lambda: kb.block_start_reference(
            c10, b10, s10, l10, ring, degrees, init_ba, traj=traj), 5),
        "k10_rec_library_ms": _device_ms(lambda: (
            s10.copy_(src.expand(2, -1)), traj.fill_(-1)), 20),
        "k10_rec_bound_ms": (k10_bytes + 4 * tw) / HBM_BYTES_PER_S * 1e3,
        "held_calls": held.calls, "max_abs_err": held.err,
        "k10_ring_hit": hit,
        "k9_ms": _device_ms(lambda: (blk.copy_(blk0), kb.block_record(
            ctrl, state, blk, best, k_min, strict_)), 20,
            "block_record_kernel"),
        "k9_cold_ms": _device_ms(lambda: (flush.zero_(), blk.copy_(blk0),
                                          kb.block_record(
            ctrl, state, blk, best, k_min, strict_)), 20,
            "block_record_kernel"),
        "k9_plain_ms": _host_ms(lambda: (blk.copy_(blk0),
                                         kb.block_record_reference(
            ctrl, state, blk, best, k_min, strict_)), 5),
        "k9_library_ms": _device_ms(lambda: (torch.amax(pe[:v]),
                                             best.copy_(pe)), 20),
        "k9_bound_ms": k9_bytes / HBM_BYTES_PER_S * 1e3,
        "k9_bytes": k9_bytes,
        "k10_ms": _device_ms(lambda: kb.block_start(
            c10, b10, s10, l10, ring, degrees, init_ba), 20,
            "block_start_kernel"),
        "k10_cold_ms": _device_ms(lambda: (flush.zero_(), kb.block_start(
            c10, b10, s10, l10, ring, degrees, init_ba)), 20,
            "block_start_kernel"),
        "k10_plain_ms": _host_ms(lambda: kb.block_start_reference(
            c10, b10, s10, l10, ring, degrees, init_ba), 5),
        "k10_library_ms": _device_ms(
            lambda: s10.copy_(src.expand(2, -1)), 20),
        "k10_bound_ms": k10_bytes / HBM_BYTES_PER_S * 1e3,
        "k10_bytes": k10_bytes,
    }


def phase_blocked_main(card: str, out_dir: Path, argv: list[str],
                       runs: tuple, graph=None) -> list[dict]:
    """``ell-compact`` through the CLI's calls on the graph ``argv`` names,
    for each ``(strict, A)`` of ``runs``: sequential at A = 1, blocked
    above. The launch counts are zeroed just before each sweep and read
    just after; a blocked sweep must launch K9 and K10, and bring no row
    of V words home between the attempts of a block. Every run's attempts
    and colors must equal the sequential run of its mode."""
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.kernels import block as kb
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.kernels import hub as kh
    from dgc_tpu_torch.ops.validate import validate_coloring

    args = cli.build_parser().parse_args(
        argv + ["--output-coloring", str(out_dir / "coloring.json")])
    if graph is None:
        graph = cli.load_graph(args)
    records, seq = [], {}
    for strict, a in runs:
        args.strict_decrement, args.attempts_per_dispatch = strict, str(a)
        engine = cli.make_engine(args, graph)
        for mod in (kc, kh, kb):
            mod.reset_launch_counts()
        engine.host_syncs = engine.d2h_bytes = 0
        timed = (_TimedBlockEngine if a > 1 else _TimedSweepEngine)(engine)
        result = cli.sweep(args, graph, timed)
        torch.cuda.synchronize()
        launches = {**kc.launch_counts, **kh.launch_counts, **kb.launch_counts}
        syncs, d2h = engine.host_syncs, engine.d2h_bytes
        val = validate_coloring(graph.arrays.indptr, graph.arrays.indices,
                                result.colors)
        check(val.valid, f"strict={strict} A={a}: invalid coloring {val}")
        rows = _attempt_rows(result)
        key = (rows, result.colors.tobytes())
        if a == 1:
            seq[strict] = key
        check(key == seq[strict], f"strict={strict} A={a}: {rows} differ "
                                  f"from the sequential sweep's {seq[strict][0]}")
        need = ("compact_slots", "segmented_superstep", "stage_finish") + (
            ("block_record", "block_start") if a > 1 else ())
        check(all(launches[n] > 0 for n in need)
              and (a > 1 or not any(kb.launch_counts.values())),
              f"strict={strict} A={a}: launches {launches}")
        n = len(result.attempts)
        rec = {"phase": "blocked_main", "graph": " ".join(argv),
               "gen": args.gen_method,
               "strict": strict, "attempts_per_dispatch": a,
               "k0": graph.initial_k(), "attempts": rows,
               "colors_swept": result.swept_colors,
               "sweep_s": result.wall_time_s - result.post_reduce_s,
               "engine_call_s": timed.seconds,
               "validation_in_loop_s": (result.wall_time_s
                                        - result.post_reduce_s
                                        - sum(timed.seconds)),
               "launches": launches, "host_syncs": syncs,
               "host_syncs_per_attempt": syncs / n, "d2h_bytes": d2h,
               "d2h_bytes_per_attempt": d2h / n, "card": card}
        if a > 1:
            rows_home = [sum(1 for _, row in b if row) for b in timed.blocks]
            small = [[nb for nb, row in b if not row] for b in timed.blocks]
            # per block at most the final attempt's row and the best row
            check(all(r <= 2 for r in rows_home),
                  f"strict={strict} A={a}: rows of V words per block "
                  f"{rows_home}")
            rec.update({
                "blocks": len(timed.blocks),
                "rows_home_per_block": rows_home,
                "d2h_bytes_between_attempts_max": max(
                    (x for b in small for x in b), default=0),
                "d2h_row_bytes": 4 * graph.num_vertices})
            if not strict:
                rec.update(measure_block(engine, graph.initial_k(), strict,
                                         rows))
                engine.host_syncs = engine.d2h_bytes = 0
                t = time.perf_counter()
                out = engine.attempt_block(graph.initial_k(), 4)
                rec["block_wall_ms"] = (time.perf_counter() - t) * 1e3
                rec["block_attempts_run"] = len(out.results)
                rec["block_host_syncs"] = engine.host_syncs
                rec["block_device_busy_ms"] = _device_ms(
                    lambda: engine.attempt_block(graph.initial_k(), 4), 1)
        emit(rec)
        records.append(rec)
        del engine, timed
    return records


def phase_main_path(card: str, out_dir: Path, argv: list[str],
                    backends: tuple, blocked_runs: tuple):
    """The CLI's calls on the graph ``argv`` names, for each of
    ``backends``, ``ell-compact`` (the default) first; its attempts and
    swept colors must equal ``ell-bucketed``'s. The launch counts are
    zeroed just before each sweep and read just after. Then
    ``phase_blocked_main`` on the same graph. Returns the records by
    backend and the blocked records."""
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.kernels import hub as kh
    from dgc_tpu_torch.kernels import superstep as ks
    from dgc_tpu_torch.ops.validate import validate_coloring

    from dgc_tpu_torch.native.bindings import native_available

    args = cli.build_parser().parse_args(
        argv + ["--output-coloring", str(out_dir / "coloring.json")])
    check(args.backend == "ell-compact", f"the CLI default is {args.backend}")
    # without the C++ library the draw would silently be the NumPy stream's
    check(native_available(), "the native library did not build: the 1M "
                              "draw would not be dgc_tpu's")
    t = time.perf_counter()
    graph = cli.load_graph(args)
    gen_s = time.perf_counter() - t
    sha = graph_sha256(graph.arrays)
    check(sha == DRAW_SHA256[args.gen_method],
          f"the {args.gen_method} draw's sha256 is {sha}, not the pinned "
          f"{DRAW_SHA256[args.gen_method]}")
    records = []
    swept = {}
    for backend in backends:
        args.backend = backend
        t = time.perf_counter()
        engine = cli.make_engine(args, graph)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        hubs = getattr(engine, "hub_buckets", 0)
        torch.cuda.reset_peak_memory_stats()
        ks.reset_launch_counts()
        kc.reset_launch_counts()
        kh.reset_launch_counts()
        engine.host_syncs = 0
        timed = (_TimedSweepEngine if hasattr(engine, "sweep")
                 else _TimedEngine)(engine)
        result = cli.sweep(args, graph, timed)
        torch.cuda.synchronize()
        launches = {**ks.launch_counts, **kc.launch_counts, **kh.launch_counts}
        own = (({**kc.launch_counts, **kh.launch_counts} if hubs else
                kc.launch_counts) if backend == "ell-compact"
               else ks.launch_counts)
        host_syncs = engine.host_syncs
        syncs_per_attempt = host_syncs / len(result.attempts)
        peak_bytes = torch.cuda.max_memory_allocated()
        check(result.colors is not None, f"{backend}: no coloring")
        val = validate_coloring(graph.arrays.indptr, graph.arrays.indices,
                                result.colors)
        check(val.valid, f"{backend}: invalid coloring {val}")
        check(all(n > 0 for n in own.values()),
              f"{backend}: the sweep skipped a kernel of its path: {launches}")
        check(backend != "ell-compact" or hubs or
              not any(kh.launch_counts.values()),
              f"{backend}: hub kernels launched on a hub-free layout")
        graph.save_coloring(args.output_coloring, result.colors)
        check(np.array_equal(graph.load_coloring(args.output_coloring),
                             result.colors), f"{backend}: coloring JSON")
        # kept for the sharded engines' runs on the same draw
        graph.save_coloring(str(out_dir / f"coloring-{args.gen_method}-"
                                          f"{backend}.json"), result.colors)
        best = [r for r in timed.results if r.success][-1]
        swept[backend] = (_attempt_rows(result), best.colors)
        sweep_s = result.wall_time_s - result.post_reduce_s
        meas = {}
        if backend == "ell-compact":
            meas = measure_compact(engine, graph.initial_k(), swept[backend][0])
        else:
            meas = measure_kernels(engine, graph.initial_k(),
                                   graph.arrays.num_directed_edges)
            if any(a == "rmat" for a in argv):
                meas.update(_k1_sweep(engine,
                                      [a.k for a in result.attempts]))
        rec = {
            "phase": "main_path", "backend": backend,
            "graph": " ".join(argv),
            "vertices": graph.num_vertices,
            "directed_edges": graph.arrays.num_directed_edges,
            "max_degree": graph.max_degree, "gen_s": gen_s,
            "generator": "native", "draw_sha256": sha,
            "engine_build_s": build_s, "sweep_s": sweep_s,
            "post_reduce_s": result.post_reduce_s,
            "attempt_s": timed.seconds,
            "supersteps": result.total_supersteps,
            "attempts": [(a.k, a.status.name, a.supersteps, a.colors_used)
                         for a in result.attempts],
            "colors_swept": result.swept_colors,
            "colors_after_post_pass": result.minimal_colors,
            "launches": launches,
            "host_syncs": host_syncs,
            "host_syncs_per_attempt": syncs_per_attempt,
            "max_memory_allocated": peak_bytes,
            "card": card, **meas,
        }
        if backend == "ell-compact":
            rec["stage_ladder"] = [list(s_) for s_ in engine.stages]
            rec["hub_buckets"] = hubs
            rec["hub_prune"] = [None if c is None else list(c)
                                for c in engine.hub_prune]
            rec["confirm_resumed_from_step"] = engine.resumed_from_step
        emit(rec)
        records.append(rec)
        del engine, timed
    a, b = swept["ell-compact"], swept["ell-bucketed"]
    check(a[0] == b[0] and np.array_equal(a[1], b[1]),
          f"ell-compact's sweep differs from ell-bucketed's: {a[0]} vs {b[0]}")
    blocked = phase_blocked_main(card, out_dir, argv, blocked_runs, graph)
    return {r["backend"]: r for r in records}, blocked


# the telemetry runs (B11): the CLI with all four telemetry flags on the
# 1M draws, against the same run with the event log alone (telemetry off)
TELEMETRY_RUNS = (
    ("uniform jump", MAIN_ARGS, []),
    ("rmat jump", RMAT_ARGS, []),
    ("uniform strict A=4", MAIN_ARGS, ["--strict-decrement",
                                       "--attempts-per-dispatch", "4"]),
    ("uniform ell-bucketed", MAIN_ARGS, ["--backend", "ell-bucketed"]),
)
# the recording kernels each run must launch, and the kernels they replace,
# which it must not
_REC_KERNELS = {
    "uniform jump": ("segmented_superstep_rec", "stage_finish_rec"),
    "rmat jump": ("segmented_superstep_rec", "stage_finish_rec",
                  "hub_superstep_rec"),
    "uniform strict A=4": ("segmented_superstep_rec", "stage_finish_rec",
                           "block_record_rec", "block_start_rec"),
    "uniform ell-bucketed": ("superstep_finish_rec",),
}


def _cli_run(argv: list[str]) -> tuple:
    """``cli.main(argv)`` with the launch counts zeroed just before and
    read just after; returns (rc, launches, the engine it built, wall s)."""
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.kernels import block as kb
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.kernels import hub as kh
    from dgc_tpu_torch.kernels import superstep as ks

    built, real = [], cli.make_engine

    def make_engine(args, graph):
        built.append(real(args, graph))
        return built[-1]

    cli.make_engine = make_engine
    try:
        for mod in (ks, kc, kh, kb):
            mod.reset_launch_counts()
        t = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        cli.make_engine = real
    launches = {name: n for mod in (ks, kc, kh, kb)
                for counts in (mod.launch_counts, mod.rec_launch_counts)
                for name, n in counts.items()}
    return rc, launches, built[-1] if built else None, wall


def _check_telemetry_files(name: str, d: Path, timing: bool) -> dict:
    """The run's JSONL, manifest and Prometheus file parse under the
    port's schema copy; every attempt has its trajectory: its rows span
    the attempt from its first step, a SUCCESS ends with no active row, a
    FAILURE's last row is its failing step (and no earlier one fails),
    ``step_us`` is −1 first and non-negative after (timed runs only)."""
    from dgc_tpu_torch.obs.manifest import load_manifest
    from dgc_tpu_torch.obs.schema import validate_record

    events = [json.loads(line) for line in
              (d / "run.jsonl").read_text().splitlines()]
    bad = [p for e in events for p in validate_record(e)]
    check(not bad, f"{name}: the event log breaks the schema: {bad[:3]}")
    attempts = [e for e in events if e["event"] == "attempt"]
    trajs = [e for e in events if e["event"] == "trajectory"]
    check(len(attempts) == len(trajs) > 0, f"{name}: {len(attempts)} "
                                           f"attempts, {len(trajs)} trajectories")
    step_us = []
    for a, t in zip(attempts, trajs):
        n = len(t["active"])
        check(t["k"] == a["k"] and t["first_step"] + n == a["supersteps"]
              and not t["truncated"], f"{name}: k={a['k']}: rows "
                                      f"{t['first_step']}+{n}, supersteps "
                                      f"{a['supersteps']}")
        if a["status"] == "SUCCESS":
            check(t["active"][-1] == 0, f"{name}: k={a['k']}: SUCCESS with "
                                        f"{t['active'][-1]} active")
        if a["status"] == "FAILURE":
            check(t["fail"][-1] == 1 and not any(t["fail"][:-1]),
                  f"{name}: k={a['k']}: fail column {t['fail']}")
        su = t.get("step_us")
        check((su is not None) == timing, f"{name}: k={a['k']}: step_us "
                                          f"{'missing' if timing else 'set'}")
        if su is not None:
            check(su[0] == -1 and all(u >= 0 for u in su[1:]),
                  f"{name}: k={a['k']}: step_us {su[:8]}")
            step_us += su[1:]
    doc = load_manifest(str(d / "manifest.json"))
    check(len(doc["attempts"]) == len(attempts) and all(
        m["trajectory"] is not None for m in doc["attempts"]),
          f"{name}: the manifest's attempts lack trajectories")
    prom = {}
    for line in (d / "metrics.prom").read_text().splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            prom[key] = float(value)
    calls = sum(1 for e in events if e["event"] == "phase")
    check(prom.get("dgc_device_dispatches_total") == calls,
          f"{name}: {prom.get('dgc_device_dispatches_total')} dispatches "
          f"counted, {calls} engine calls")
    return {"attempts": len(attempts), "trajectory_rows":
            sum(len(t["active"]) for t in trajs),
            "dispatches": calls,
            "blocks": sum(1 for e in events if e["event"] == "attempt_block"),
            "step_us_median": float(np.median(step_us)) if step_us else None,
            "step_us_sum": int(sum(step_us)),
            "engine_call_s": [e["seconds"] for e in events
                              if e["event"] == "phase"],
            "first_trajectory": {k: trajs[0][k][:12] for k in (
                "active", "gather_calls", "max_unconf", "step_us")
                if k in trajs[0]}}


# one run a side: off, then on (each run holds its recording kernels'
# launches and results against the other; the timings are one sample)
TELEMETRY_ORDER = (False, True)


def _spread(off: list[float], on: list[float]) -> dict:
    """Median and range of each side; the difference is resolved only where
    the two ranges do not overlap."""
    return {"off": off, "on": on,
            "off_median": float(np.median(off)),
            "on_median": float(np.median(on)),
            "off_range": [min(off), max(off)], "on_range": [min(on), max(on)],
            "resolved": max(off) < min(on) or max(on) < min(off)}


def phase_telemetry_main(card: str, out_dir: Path) -> dict:
    """Each of ``TELEMETRY_RUNS`` through ``cli.main`` on the card, in the
    order ``TELEMETRY_ORDER``: with ``--log-json`` alone (telemetry off),
    or with all four flags. The launch counts are zeroed just before each
    run and read just after: a telemetry run must launch the recording
    kernels of its path and not the ones they replace, a run without the
    reverse. Every run's coloring JSON and attempts must be byte for byte
    the first telemetry-off run's, the host syncs the same, and the bytes
    copied home larger by the trajectory buffers alone
    (``_check_telemetry_files`` checks the rest of each telemetry run).
    The engine time and the CLI's wall time of each side are reported as
    median and range. Returns the records by run."""
    from dgc_tpu_torch.obs.kernel import traj_cap_for, traj_cols

    out = {}
    for name, graph_args, extra in TELEMETRY_RUNS:
        runs = {False: [], True: []}
        timing = "ell-bucketed" not in extra
        files = None
        for i, tel in enumerate(TELEMETRY_ORDER):
            d = out_dir / f"telemetry-{name.replace(' ', '-')}-{i}"
            d.mkdir(parents=True, exist_ok=True)
            argv = graph_args + extra + [
                "--output-coloring", str(d / "colors.json"),
                "--log-json", str(d / "run.jsonl")]
            if tel:
                argv += ["--run-manifest", str(d / "manifest.json"),
                         "--metrics-prom", str(d / "metrics.prom"),
                         "--superstep-timing"]
            rc, launches, engine, wall = _cli_run(argv)
            check(rc == 0, f"{name}: the CLI exited {rc}")
            need = _REC_KERNELS[name]
            off = [n[:-4] for n in need]
            on_names, off_names = (need, off) if tel else (off, need)
            check(all(launches[n] > 0 for n in on_names)
                  and not any(launches[n] for n in off_names),
                  f"{name} (telemetry {'on' if tel else 'off'}): launches "
                  f"{launches}")
            events = [json.loads(line) for line in
                      (d / "run.jsonl").read_text().splitlines()]
            runs[tel].append({
                "dir": d, "launches": launches, "wall_s": wall,
                "colors": (d / "colors.json").read_bytes(),
                "attempts": [{k: v for k, v in e.items() if k != "t"}
                             for e in events if e["event"] == "attempt"],
                "engine_s": sum(e["seconds"] for e in events
                                if e["event"] == "phase"),
                "host_syncs": engine.host_syncs,
                "d2h_bytes": getattr(engine, "d2h_bytes", None),
                "traj_bytes": 4 * traj_cap_for(engine.max_steps) * traj_cols(
                    len(getattr(engine, "init_bucket_active", ())),
                    hasattr(engine, "init_bucket_active"))})
            del engine
            if tel:
                checked = _check_telemetry_files(name, d, timing)
                files = files or checked
        a, b = runs[False][0], runs[True][0]
        for r, same in ((r, side[0]) for side in runs.values()
                        for r in side):
            check(r["colors"] == a["colors"] and r["attempts"] == a["attempts"],
                  f"{name}: telemetry on changed the result")
            check(r["host_syncs"] == a["host_syncs"],
                  f"{name}: host syncs {a['host_syncs']} off, "
                  f"{r['host_syncs']} in {r['dir'].name}")
            check(r["launches"] == same["launches"]
                  and r["d2h_bytes"] == same["d2h_bytes"],
                  f"{name}: {r['dir'].name} launched {r['launches']} and "
                  f"copied {r['d2h_bytes']} B home, {same['dir'].name} "
                  f"{same['launches']} and {same['d2h_bytes']} B")
        n_att = len(b["attempts"])
        rec = {"phase": "telemetry_main", "run": name,
               "graph": " ".join(graph_args + extra), "attempts": n_att,
               "order": ["on" if t else "off" for t in TELEMETRY_ORDER],
               "launches": b["launches"],
               "sweep_engine_s": _spread([r["engine_s"] for r in runs[False]],
                                         [r["engine_s"] for r in runs[True]]),
               "cli_wall_s": _spread([r["wall_s"] for r in runs[False]],
                                     [r["wall_s"] for r in runs[True]]),
               "host_syncs": b["host_syncs"],
               "host_syncs_per_attempt": b["host_syncs"] / n_att,
               "traj_buffer_bytes": b["traj_bytes"], "card": card, **files}
        if b["d2h_bytes"] is not None:
            # one buffer per attempt, or a stack of A per block
            a_blk = 4 if "--attempts-per-dispatch" in extra else 1
            n_buf = files["blocks"] * a_blk if a_blk > 1 else n_att
            extra_bytes = b["d2h_bytes"] - a["d2h_bytes"]
            check(extra_bytes == n_buf * b["traj_bytes"],
                  f"{name}: {extra_bytes} more bytes home, the trajectory "
                  f"buffers are {n_buf} x {b['traj_bytes']}")
            rec.update({"d2h_bytes_per_attempt_off": a["d2h_bytes"] / n_att,
                        "d2h_bytes_per_attempt_on": b["d2h_bytes"] / n_att})
        emit(rec)
        out[name] = rec
    return out


# ---- the dense engine at full width ------------------------------------------

DENSE_V = 16384  # the dense engine's cap
DENSE_REPS = 3  # replays of each superstep in the timing profile
DENSE_ARGS = {gen: ["--node-count", str(DENSE_V), "--max-degree", "32",
                    "--gen-method", gen, "--seed", "0", "--backend", "dense"]
              for gen in ("fast", "rmat")}


class _HeldDenseKernels:
    """While active, every K11 and K12 call made through
    ``kernels.dense``'s wrappers (as the engine makes them) also runs its
    plain version on copies of its inputs; ``err`` is the largest
    difference seen over ``calls`` calls, ``resolve_rows`` the rows each
    K12 call ranked (uncolored, below v; none on a failed step)."""

    def __enter__(self):
        from dgc_tpu_torch.kernels import dense as kd

        self.kd, self.err, self.calls, self.resolve_rows = kd, 0, 0, []
        self._orig = forbid, resolve = kd.dense_forbid, kd.dense_resolve

        def held_forbid(ctrl, state, adj, cand, v, k):
            ref = [t.clone() for t in (ctrl, state, cand)]
            kd.dense_forbid_reference(ref[0], ref[1], adj, ref[2], v, k)
            forbid(ctrl, state, adj, cand, v, k)
            self._hold((ctrl, state, cand), ref)

        def held_resolve(ctrl, state, adj, cand, degrees, v, max_steps):
            if int(ctrl[kd.DCTRL_STATUS]) == int(kd.AttemptStatus.RUNNING) \
                    and not int(ctrl[kd.DCTRL_FAIL]):
                self.resolve_rows.append(int((cand[:v] >= 0).sum()))
            ref = [t.clone() for t in (ctrl, state)]
            kd.dense_resolve_reference(ref[0], ref[1], adj, cand, degrees, v,
                                       max_steps)
            resolve(ctrl, state, adj, cand, degrees, v, max_steps)
            self._hold((ctrl, state), ref)

        kd.dense_forbid, kd.dense_resolve = held_forbid, held_resolve
        return self

    def _hold(self, got, want) -> None:
        self.calls += 1
        self.err = max(self.err, *(_diff(a, b) for a, b in zip(got, want)))

    def __exit__(self, *exc):
        self.kd.dense_forbid, self.kd.dense_resolve = self._orig
        return False


def measure_dense(engine, k: int) -> dict:
    """K11 and K12 over the supersteps of the attempt at ``k``: device time
    per superstep from ``torch.profiler``, the bound this data needs (K11
    reads the adjacency rows of a step's uncolored vertices; K12 a kept
    row's whole row and a sector of a beaten one), the plain
    versions' time, and the library yardstick for K11 (``torch.matmul``
    of the adjacency and the bf16 one-hot, then the first-fit argmax),
    its device time from ``torch.profiler`` too (every event of a call)."""
    from dgc_tpu_torch.engine.base import AttemptStatus, clamp_budget
    from dgc_tpu_torch.kernels import dense as kd

    adj, deg, v = engine.adj, engine.degrees, engine.num_vertices
    vp, dev = adj.shape[0], adj.device
    k_run = clamp_budget(k, engine.kmax)
    max_steps = engine.max_steps

    def fresh():
        return (kd.new_dense_ctrl(dev), kd.new_dense_state(engine._colors0),
                torch.empty(vp, dtype=torch.int32, device=dev))

    # one superstep at a time: what each step's data needs
    ctrl, state, cand = fresh()
    steps, kept, mid = [], [], None
    while int(ctrl[kd.DCTRL_STATUS]) == int(AttemptStatus.RUNNING):
        colors = state[int(ctrl[kd.DCTRL_CUR])]
        if len(steps) == 2:
            mid = colors.clone()
        uncolored = int((colors[:v] < 0).sum())
        kd.dense_forbid(ctrl, state, adj, cand, v, k_run)
        failed = int(ctrl[kd.DCTRL_FAIL]) != 0
        kd.dense_resolve(ctrl, state, adj, cand, deg, v, max_steps)
        after = int((state[int(ctrl[kd.DCTRL_CUR])][:v] < 0).sum())
        steps.append(uncolored)
        # the rows that keep their candidate (None: a failed step)
        kept.append(None if failed else uncolored - after)
    n = len(steps)
    mid = state[int(ctrl[kd.DCTRL_CUR])].clone() if mid is None else mid
    k11_bytes = sum(u * vp * 2 + 2 * vp * 4 for u in steps) / n
    k12_full_bytes = sum(u * vp * 2 + 3 * vp * 4 + v * 4 for u in steps) / n
    # what K12 needs of this data: a kept row's whole adjacency row (no
    # beater anywhere), one 32-byte sector of a beaten row (one that holds
    # a beater), the candidates, degrees and the source colors once and the
    # new colors written; a failed step reads its control block alone
    k12_bytes = sum(0 if k_ is None else k_ * vp * 2 + (u - k_) * 32
                    + 3 * vp * 4 + v * 4 for u, k_ in zip(steps, kept)) / n

    # the same supersteps under one profile, each replayed DENSE_REPS times
    # from its control block (K11 rewrites `cand`, K12 the other buffer:
    # a replay does the same work); the mean over the launches the
    # profiler recorded, at least 90 % of them (a long window can drop a
    # few records, which single-step windows did not avoid either)
    def replay():
        ctrl, state, cand = fresh()
        for _ in range(n):
            snap = ctrl.clone()
            for _ in range(DENSE_REPS):
                ctrl.copy_(snap)
                kd.dense_forbid(ctrl, state, adj, cand, v, k_run)
                kd.dense_resolve(ctrl, state, adj, cand, deg, v, max_steps)

    sums = _profiled(replay, {"dense_forbid": n * DENSE_REPS,
                              "dense_resolve": n * DENSE_REPS}, 0.9)
    dev_ms = {name: sums[name][0] / sums[name][1] for name in
              ("dense_forbid", "dense_resolve")}
    def by_step(name):  # by superstep, where no record was lost
        each = sums[name][2]
        return ([sum(each[i * DENSE_REPS:(i + 1) * DENSE_REPS]) / DENSE_REPS
                 for i in range(n)] if len(each) == n * DENSE_REPS else None)

    # the plain versions over the same supersteps, host clock each call
    plain = {"forbid": 0.0, "resolve": 0.0}
    ctrl, state, cand = fresh()
    for _ in range(n):
        for name, fn, a in (
                ("forbid", kd.dense_forbid_reference, (cand, v, k_run)),
                ("resolve", kd.dense_resolve_reference,
                 (cand, deg, v, max_steps))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(ctrl, state, adj, *a)
            torch.cuda.synchronize()
            plain[name] += time.perf_counter() - t

    col = torch.arange(engine.kmax, device=dev)

    def library():
        onehot = (mid[:, None] == col[None, :]).to(torch.bfloat16)
        counts = torch.matmul(adj, onehot)
        free = (counts < 0.5) & (col[None, :] < k_run)
        return free.to(torch.uint8).argmax(dim=1)

    full_bytes = vp * vp * 2
    return {
        "dense_k": k_run, "dense_supersteps": n, "kmax": engine.kmax,
        "uncolored_per_step": steps,
        "k11_ms": dev_ms["dense_forbid"],
        "k11_ms_by_step": by_step("dense_forbid"),
        "k11_plain_ms": plain["forbid"] * 1e3 / n,
        "k11_bytes": k11_bytes,
        # a bit per nonzero and a search of the mask: far below the bytes
        "k11_bound_ms": k11_bytes / HBM_BYTES_PER_S * 1e3,
        "k11_bound_by": "bytes",
        "k11_library_ms": _device_ms(library, 10),
        "k12_ms": dev_ms["dense_resolve"],
        "k12_ms_by_step": by_step("dense_resolve"),
        # the attempt's K12 launches, summed
        "k12_attempt_ms": dev_ms["dense_resolve"] * n,
        "profiled_launches": {name: sums[name][1] for name in dev_ms},
        "k12_plain_ms": plain["resolve"] * 1e3 / n,
        "k12_kept_per_step": kept,
        "k12_bytes": k12_bytes,
        "k12_bound_ms": k12_bytes / HBM_BYTES_PER_S * 1e3,
        # the bound of PRs 6-19: every uncolored row read whole
        "k12_full_rows_bound_ms": k12_full_bytes / HBM_BYTES_PER_S * 1e3,
        # the whole adjacency once
        "full_adjacency_bytes": full_bytes,
        "full_adjacency_bound_ms": full_bytes / HBM_BYTES_PER_S * 1e3,
    }


def dense_cpu_reference(out: str) -> str:
    """The CLI on the CPU (the plain K11 and K12) at the 16,384-vertex
    RMAT flags; runs in a child process beside the card's phases. Returns
    the coloring JSON's path."""
    from dgc_tpu_torch import cli

    torch.set_num_threads(4)
    rc = cli.main(DENSE_ARGS["rmat"] + ["--device", "cpu",
                                        "--output-coloring", out])
    check(rc == 0, f"the CPU CLI run exited {rc}")
    return out


def phase_dense_main(card: str, out_dir: Path, cpu_coloring: str) -> dict:
    """The dense backend through the CLI's calls (``cli.load_graph``,
    ``make_engine``, ``sweep``) at 16,384 vertices, uniform and RMAT. The
    launch counts are zeroed just before each sweep and read just after;
    both kernels must launch. The same sweep again with every K11 and K12
    call held against its plain version on the card's tensors must give
    the same attempts and colors. Then ``oracle`` and ``reference-sim``
    on the same graph, and the CLI itself (``python -m dgc_tpu_torch``,
    ``--device cuda``) on the RMAT flags, whose coloring JSON must equal
    the ``--device cpu`` run's (``cpu_coloring``)."""
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.kernels import dense as kd
    from dgc_tpu_torch.ops.validate import validate_coloring

    records = {}
    for gen, argv in DENSE_ARGS.items():
        args = cli.build_parser().parse_args(
            argv + ["--output-coloring", str(out_dir / "dense.json")])
        t = time.perf_counter()
        graph = cli.load_graph(args)
        gen_s = time.perf_counter() - t
        t = time.perf_counter()
        engine = cli.make_engine(args, graph)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        check(type(engine).__name__ == "DenseEngine", f"{type(engine)}")
        torch.cuda.reset_peak_memory_stats()
        kd.reset_launch_counts()
        engine.host_syncs = 0
        timed = _TimedEngine(engine)
        result = cli.sweep(args, graph, timed)
        torch.cuda.synchronize()
        launches = dict(kd.launch_counts)
        peak_bytes = torch.cuda.max_memory_allocated()
        check(all(n > 0 for n in launches.values()),
              f"dense on {gen}: the sweep skipped a kernel: {launches}")
        val = validate_coloring(graph.arrays.indptr, graph.arrays.indices,
                                result.colors)
        check(val.valid, f"dense on {gen}: invalid coloring {val}")
        graph.save_coloring(args.output_coloring, result.colors)
        check(np.array_equal(graph.load_coloring(args.output_coloring),
                             result.colors), f"dense on {gen}: coloring JSON")
        rows = _attempt_rows(result)
        with _HeldDenseKernels() as held:
            again = cli.sweep(args, graph, engine)
        torch.cuda.synchronize()
        check(held.err == 0 and held.calls > 0,
              f"dense on {gen}: K11/K12 disagree with their plain versions "
              f"over the sweep ({held.err} over {held.calls} calls)")
        # K12 sizes a row's team by the rows a block holds (one block an
        # SM): the sweep must take one warp a row (32 rows a block and more)
        # and the whole block a row (one row a block at most)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        check(max(held.resolve_rows, default=0) >= 32 * sms
              and min(held.resolve_rows, default=sms + 1) <= sms,
              f"dense on {gen}: K12's calls ranked {held.resolve_rows} rows, "
              f"not both past {32 * sms} and within {sms}")
        check(_attempt_rows(again) == rows
              and np.array_equal(again.colors, result.colors),
              f"dense on {gen}: the held sweep gave {_attempt_rows(again)}, "
              f"the kernels' {rows}")
        rec = {"phase": "dense_main", "backend": "dense",
               "graph": " ".join(argv), "vertices": graph.num_vertices,
               "directed_edges": graph.arrays.num_directed_edges,
               "max_degree": graph.max_degree, "gen_s": gen_s,
               "engine_build_s": build_s,
               "sweep_s": result.wall_time_s - result.post_reduce_s,
               "post_reduce_s": result.post_reduce_s,
               "attempt_s": timed.seconds, "attempts": rows,
               "supersteps": result.total_supersteps,
               "colors_swept": result.swept_colors,
               "colors_after_post_pass": result.minimal_colors,
               "launches": launches, "host_syncs": engine.host_syncs,
               "held_calls": held.calls, "max_abs_err": held.err,
               "k12_held_rows": held.resolve_rows,
               "max_memory_allocated": peak_bytes, "card": card,
               **measure_dense(engine, graph.initial_k())}
        del engine, timed
        for backend in cli.HOST_BACKENDS:
            args.backend = backend
            t = time.perf_counter()
            res = cli.sweep(args, graph, cli.make_engine(args, graph))
            val = validate_coloring(graph.arrays.indptr, graph.arrays.indices,
                                    res.colors)
            check(val.valid, f"{backend} on {gen}: invalid coloring {val}")
            rec[backend] = {"seconds": time.perf_counter() - t,
                            "attempts": _attempt_rows(res),
                            "colors": res.minimal_colors}
        emit(rec)
        records[gen] = rec
    # the user's command on the card, against the CPU run's file
    out = out_dir / "dense_cli.json"
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dgc_tpu_torch", *DENSE_ARGS["rmat"],
         "--output-coloring", str(out)], capture_output=True, text=True,
        timeout=600)
    cli_s = time.perf_counter() - t
    check(proc.returncode == 0, f"the dense CLI exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    check(out.read_bytes() == Path(cpu_coloring).read_bytes(),
          "the dense CLI's coloring on the card differs from --device cpu's")
    records["rmat"]["cli_cuda_s"] = cli_s
    records["rmat"]["cli_equals_cpu"] = True
    emit({"phase": "dense_cli", "argv": DENSE_ARGS["rmat"], "seconds": cli_s,
          "equals_cpu": True,
          "stdout_tail": proc.stdout.strip().splitlines()[-3:]})
    return records


# ---- the serve tier (B12): K13-K16 ------------------------------------------

# (lanes, width, rows) of the random serve cases: 1 to 32 planes, K13's
# groups of 1, 2 and 32 lanes a row; V <= 32,768 runs K13's staged
# instance (its blocks gather from the staged state on the full table and
# the shallow rung, from device memory on the deep one: kernels.serve.
# superstep_plan), V = 40,000 its global one
SERVE_KERNEL_CASES = ((1, 8, 3000), (3, 64, 1200), (8, 1023, 300),
                      (3, 8, 3000), (8, 64, 1200), (1, 1023, 300),
                      (4, 32, 2048), (2, 32, 40000))
# (lanes, width, rows) of the replayed inputs: a few lanes a block staged,
# more lanes than blocks (each block stages its lanes one after another),
# the global instance
SERVE_REPLAY_CASES = ((8, 32, 2048), (1000, 8, 2048), (2, 32, 40000))
SERVE_ROUNDS = 8
# armed lanes of the 500k strict chain's class (lanes, width, rows:
# v524288w32, 67 MB a lane) at the width of its --speculate-k 3 pool,
# unstaged with timing off and staged with timing on
SERVE_SPEC_WIDE = (4, 32, 524288)


def _serve_ladder(v: int) -> tuple:
    """A 3-rung ladder valid for ``v`` rows (pads pow2(v/2), pow2(v/8))."""
    return ((None, v // 2), (v // 2, v // 8), (v // 8, 0))


def _serve_table(rng, b: int, v: int, w: int, dummies: float = 0.0):
    """Seeded lane tables as ``pad_member`` lays them out: a row's degree
    real entries (ids below ``v``, a random beats bit) first, the sentinel
    ``v`` after them (K13 walks a row up to its degree); with ``dummies``,
    that share of the lanes the class dummy (degree 0, every entry the
    sentinel). Returns (comb, degrees)."""
    degrees = rng.integers(0, w + 1, size=(b, v))
    degrees[rng.random((b, v)) < 0.2] = 0
    degrees[rng.random(b) < dummies] = 0
    nbr = rng.integers(0, v, size=(b, v, w))
    beats = rng.integers(0, 2, size=(b, v, w))
    comb = np.where(np.arange(w) < degrees[..., None], nbr | (beats << 30), v)
    return comb.astype(np.int32), degrees


def _serve_lanes(rng, b: int, w: int, v: int, staged: bool, device,
                 armed: bool = False):
    """Seeded random lanes: inputs (``_serve_table``, dummy lanes among
    them) and a carry with lanes in every phase,
    dead ones, random rungs and slot lists (forced staged rungs with
    ``staged``), budgets and ``max_steps`` that end attempts; the reset
    flags raised at random; with ``armed``, spec tags in half the carry's
    lanes and random spec and cancel vectors (cancels on reset, dead and
    spec-free lanes among them). Returns (Lanes for the kernels, Lanes for
    the plain versions) with equal contents."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.ops.bitmask import num_planes_for
    from dgc_tpu_torch.serve.batched import resolve_stages

    stages, _pads, a0 = resolve_stages(_serve_ladder(v), v)
    n = len(stages)
    comb, degrees = _serve_table(rng, b, v, w, dummies=0.2)
    k = rng.integers(1, w + 2, size=b)
    step = rng.integers(1, 40, size=b)
    max_steps = rng.integers(2, 2 * v + 4, size=b)
    clamp = rng.random(b) < 0.25
    max_steps[clamp] = step[clamp] + 1 + rng.integers(0, 3, size=int(clamp.sum()))
    idx = np.full((b, a0), v)
    for lane in range(b):
        m = int(rng.integers(0, min(a0, v) + 1))
        idx[lane, :m] = np.sort(rng.choice(v, size=m, replace=False))
    colors = min(w + 4, 32 * num_planes_for(w + 1))
    words = lambda: np.stack([_packed_words(rng, v, colors, 0.4)
                              for _ in range(b)])
    carry = [rng.choice([0, 1, 2, 3], size=b, p=[0.4, 0.3, 0.2, 0.1]), k,
             words(), step, rng.integers(0, v + 2, size=b),
             rng.integers(0, 70, size=b), words(),
             rng.integers(0, 50, size=b), rng.integers(0, 4, size=b),
             rng.integers(0, w + 2, size=b), words(),
             rng.integers(0, 50, size=b), rng.integers(0, 4, size=b),
             rng.integers(0, 10_000, size=b),
             np.where(rng.random(b) < 0.5, 0, rng.integers(1, 1 << 30, size=b)),
             rng.integers(1 if staged else 0, n, size=b),
             rng.integers(0, v + 1, size=b), rng.integers(0, n, size=b), idx,
             (rng.random(b) < (0.5 if armed else 0.15)).astype(np.int64)]
    reset = (rng.random(b) < 0.3).astype(np.int64)
    spec = (rng.random(b) < 0.5).astype(np.int64)
    cancel = (rng.random(b) < 0.5).astype(np.int64)

    def lanes():
        t = lambda x: torch.tensor(np.asarray(x, np.int32), device=device)
        L = ks.new_lanes([t(c) for c in carry], t(comb), t(degrees), t(k),
                         t(max_steps), t(reset),
                         ks.ladder_ctrl(stages, device),
                         planes=num_planes_for(w + 1), stall_window=64,
                         budget=SERVE_ROUNDS)
        if armed:
            L.arm_spec(t(spec), t(cancel))
        return L
    return lanes(), lanes()


def _serve_diff(kern, plain, clock: tuple, before,
                ctrl_len: int | None = None) -> int:
    """Max abs difference of every buffer of two Lanes (the control block's
    first ``ctrl_len`` words where given); the carry slots in
    ``clock`` (those the step's clock reading feeds: T_PREV in K16, T_US
    and T_PREV in K15 under timing) by rule: equal where the plain
    version's did not move (from ``before``), else the kernel's moved too,
    T_PREV to one masked reading for all lanes, T_US forward. Then the
    plain Lanes adopt the kernel's clock slots, so the next step compares
    like with like."""
    from dgc_tpu_torch.layout import CARRY_LEN, T_PREV, T_US, US_MASK

    worst = 0
    for j in range(CARRY_LEN):
        if j in clock:
            continue
        worst = max(worst, _diff(kern.carry[j], plain.carry[j]))
    for name in ("nxt", "scratch"):
        worst = max(worst, _diff(getattr(kern, name), getattr(plain, name)))
    worst = max(worst, _diff(kern.ctrl[:ctrl_len], plain.ctrl[:ctrl_len]))
    # K14's epoch (the flags after it are the kernel's alone)
    ke = getattr(kern, "compact_scratch", None)
    pe = getattr(plain, "compact_scratch", None)
    if ke is not None and pe is not None:
        worst = max(worst, _diff(ke[:1], pe[:1]))
    for j in clock:
        k_, p_, b_ = kern.carry[j], plain.carry[j], before[j]
        moved = p_ != b_
        check(torch.equal(moved, k_ != b_) and torch.equal(
            k_[~moved], p_[~moved]), f"clock slot {j}: kernel {k_.tolist()}, "
            f"plain {p_.tolist()}, before {b_.tolist()}")
        if j == T_PREV and bool(moved.any()):
            seen = k_[moved].unique()
            check(len(seen) == 1 and 0 <= int(seen[0]) <= US_MASK,
                  f"T_PREV readings {seen.tolist()}")
        if j == T_US:
            check(bool((k_[moved] >= b_[moved]).all()), "T_US went back")
        plain.carry[j].copy_(k_)
    return worst


def _k13_paths(L, paths: dict) -> dict:
    """K13's plan on ``L`` (``kernels.serve.superstep_plan``), before its
    launch, tallied into ``paths``: launches with a block that gathers
    from the staged state (``shared``), with one that gathers from device
    memory in a staged class (``global``) or in a wider one (``wide``)."""
    from dgc_tpu_torch.kernels import serve as ks

    plan = ks.superstep_plan(L)
    paths["shared"] += plan["shared"] > 0
    paths["global" if L.v <= 32768 else "wide"] += plan["global"] > 0
    return plan


def _serve_replays(rng, device) -> int:
    """K13 and K15 each launched ``REPLAYS`` times on one input of each of
    ``SERVE_REPLAY_CASES`` (after K16): every launch gives the first one's
    bytes, and the first the plain version's; the many-lane case gives
    some block several lanes to stage. Returns the max abs error."""
    from dgc_tpu_torch.kernels import serve as ks

    worst = 0
    several = False
    for b, w, v in SERVE_REPLAY_CASES:
        kern, plain = _serve_lanes(rng, b, w, v, False, device)
        ks.lane_reset(kern)
        ks.lane_reset_reference(plain, False)
        base = [t.clone() for t in kern.carry + [kern.nxt, kern.scratch,
                                                 kern.ctrl]]

        def restore(L):
            for t, b_ in zip(L.carry + [L.nxt, L.scratch, L.ctrl], base):
                t.copy_(b_)

        plan = ks.superstep_plan(kern)
        nlive = int((kern.carry[0] < 2).sum())
        several |= plan["shared"] > 0 and nlive > plan["grid"]
        for launch, reference in (
                (ks.lane_superstep, ks.lane_superstep_reference),
                (ks.lane_finish,
                 lambda L: ks.lane_finish_reference(L, False))):
            launch(kern)
            reference(plain)
            want = [t.clone() for t in kern.carry + [kern.nxt, kern.scratch,
                                                     kern.ctrl]]
            worst = max(worst, _serve_diff(kern, plain, (), want[:20]))
            for _ in range(REPLAYS):
                restore(kern)
                launch(kern)
                worst = max(worst, max(_diff(a, b_) for a, b_ in zip(
                    kern.carry + [kern.nxt, kern.scratch, kern.ctrl], want)))
            base = want  # K15 replays from K13's output
        torch.cuda.synchronize()
    check(several, "no replayed K13 block staged several lanes")
    return worst


# K14's cases: (lanes, width, rows, what it holds). Every lane's active
# count is chosen (some past the rung's pad, some 0); dead lanes and lanes
# whose list is already at the rung are among them.
K14_CASES = ((1, 8, 131072, "one lane of v131072"),
             (12, 8, 32768, "lanes of different counts"),
             (5, 8, 3001, "rows not 16-byte aligned"),
             (128, 1, 65536, "a lane's part of several tiles"),
             (600, 1, 20000, "more lanes than blocks and than a tile"))
K14_BACK_TO_BACK = 6  # rebuilds in a row on one batch's scratch


def _k14_batch(rng, b: int, w: int, v: int, device):
    """Lanes (kernel, plain) at rung 1 of ``_serve_ladder(v)``: the live
    word set, every lane's active count drawn from none, one, around the
    rung's pad, past it and every row; a lane dead or already at the rung
    now and then."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.layout import (CARRY_IDX, CARRY_IDX_RUNG, CARRY_LEN,
                                      CARRY_P1, CARRY_P2, CARRY_PACKED,
                                      CARRY_PHASE)
    from dgc_tpu_torch.serve.batched import resolve_stages

    stages, pads, a0 = resolve_stages(_serve_ladder(v), v)
    carry = [np.zeros((b, a0) if j == CARRY_IDX else
                      (b, v) if j in (CARRY_PACKED, CARRY_P1, CARRY_P2)
                      else (b,), dtype=np.int32) for j in range(CARRY_LEN)]
    carry[CARRY_PACKED][:] = _k14_words(rng, b, v, pads[1])
    carry[CARRY_IDX][:] = v
    carry[CARRY_PHASE][:] = np.where(rng.random(b) < 0.1, 2, rng.integers(
        0, 2, b))
    carry[CARRY_IDX_RUNG][:] = np.where(rng.random(b) < 0.1, 1, 0)
    comb = np.full((b, v, w), v, dtype=np.int32)
    zeros = np.zeros(b, dtype=np.int32)

    def lanes():
        t = lambda x: torch.tensor(np.asarray(x, np.int32), device=device)
        ctrl = ks.ladder_ctrl(stages, device)
        ctrl[ks.CTRL_LIVE] = 1
        ctrl[ks.CTRL_REXEC] = 1
        L = ks.new_lanes([t(c) for c in carry], t(comb),
                         t(np.zeros((b, v))), t(zeros), t(zeros), t(zeros),
                         ctrl, planes=1, stall_window=64, budget=1)
        L.scratch.zero_()  # K16's to fill; K14 reads none of it
        return L
    return lanes(), lanes()


def _k14_words(rng, b: int, v: int, pad: int) -> np.ndarray:
    """``b`` lanes of packed words, each with an active count drawn from
    0, 1, pad - 1, pad, pad + 1, a random count and v (every row)."""
    out = np.empty((b, v), dtype=np.int32)
    for lane in range(b):
        n = int(rng.choice([0, 1, min(pad - 1, v), min(pad, v),
                            min(pad + 1, v), int(rng.integers(0, v + 1)), v]))
        active = np.zeros(v, dtype=bool)
        active[rng.choice(v, size=n, replace=False)] = True
        col = rng.integers(0, 40, v)
        out[lane] = np.where(active, np.where(rng.random(v) < 0.5, -1,
                                              col * 2 + 1), col * 2)
    return out


def _k14_cases(device) -> int:
    """K14 against its plain version on ``K14_CASES`` (every buffer and
    the scratch's epoch compared after each launch), then
    ``K14_BACK_TO_BACK`` rebuilds in a row on the lanes of different
    counts (new words, rungs 1 and 2 in turn, a launch with no lane to
    rebuild and one past the live word between them) on the one scratch
    their lanes were made with: its epoch must count the launches that
    rebuilt. Returns the max abs error."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.layout import CARRY_IDX_RUNG, CARRY_PACKED

    rng = np.random.default_rng(14)
    worst = 0
    over = 0

    def held(kern, plain):
        nonlocal worst
        before = [c.clone() for c in plain.carry]
        ks.lane_compact(kern)
        ks.lane_compact_reference(plain)
        worst = max(worst, _serve_diff(kern, plain, (), before))

    for b, w, v, _what in K14_CASES:
        kern, plain = _k14_batch(rng, b, w, v, device)
        pad = int(plain.ctrl[ks.CTRL_PAD0 + 1])
        over += int(((plain.carry[CARRY_PACKED] < 0)
                     | (plain.carry[CARRY_PACKED] & 1 == 1)).sum(1)
                    .gt(pad).sum())
        held(kern, plain)
        del kern, plain
    kern, plain = _k14_batch(rng, 12, 8, 32768, device)
    rebuilt = 0
    for i in range(K14_BACK_TO_BACK):
        words = torch.from_numpy(_k14_words(rng, 12, 32768, 1 << 14))
        rung = 1 + i % 2
        for L in (kern, plain):
            L.carry[CARRY_PACKED].copy_(words)
            L.carry[CARRY_IDX_RUNG].fill_(rung - 1)
            L.ctrl[ks.CTRL_REXEC] = rung
        rebuilt += bool((plain.carry[0] < 2).any())
        held(kern, plain)
        held(kern, plain)  # every list now at the rung: nothing to rebuild
        for L in (kern, plain):
            L.ctrl[ks.CTRL_LIVE] = 0
            L.carry[CARRY_IDX_RUNG].zero_()
        held(kern, plain)  # past the live word
        for L in (kern, plain):
            L.ctrl[ks.CTRL_LIVE] = 1
    torch.cuda.synchronize()
    epoch = int(kern.compact_scratch[0])
    check(epoch == rebuilt, f"K14's epoch {epoch} after {rebuilt} rebuilds")
    check(over > 0, "no K14 case had a lane past its pad")
    return worst


def phase_serve_kernels(device) -> int:
    """K13-K16 against their plain versions on the card, on seeded random
    lanes (``_serve_lanes``): K16 on the random reset flags, then
    ``SERVE_ROUNDS`` rounds of K14, K13 and K15, every buffer compared
    after every launch, timing off and on, unarmed and armed with random
    spec and cancel vectors (K16 must kill some lane and leave a reset
    lane it was told to cancel alive), K13's paths tallied from its plan
    (``_k13_paths``: each must run); then the armed lanes of
    ``SERVE_SPEC_WIDE``; then ``_serve_replays``. Returns the max abs
    error."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.layout import T_PREV, T_US

    worst = 0
    rexecs, compacted = set(), 0
    killed = spared = 0
    rng = np.random.default_rng(41)
    steps = ((ks.lane_compact, ks.lane_compact_reference, False),
             (ks.lane_superstep, ks.lane_superstep_reference, False),
             (ks.lane_finish, ks.lane_finish_reference, True))
    cases = [(b, w, v, s_, t_, a_) for b, w, v in SERVE_KERNEL_CASES
             for s_ in (False, True) for t_ in (False, True)
             for a_ in (False, True)]
    cases += [(*SERVE_SPEC_WIDE, s_, s_, True) for s_ in (False, True)]
    paths = {"shared": 0, "global": 0, "wide": 0}
    for b, w, v, staged, timing, armed in cases:
        kern, plain = _serve_lanes(rng, b, w, v, staged, device, armed)
        before = [c.clone() for c in plain.carry]
        ks.lane_reset(kern, timing)
        ks.lane_reset_reference(plain, timing)
        if armed:
            alive = before[0] < 2
            fresh = plain.reset != 0
            killed += int((alive & (plain.carry[0] == 2)).sum())
            spared += int((fresh & (plain.cancel != 0)
                           & (plain.spec != 0)).sum())
        worst = max(worst, _serve_diff(
            kern, plain, (T_PREV,) if timing else (), before))
        for _ in range(SERVE_ROUNDS):
            rexecs.add(int(plain.ctrl[ks.CTRL_REXEC]))
            for launch, reference, timed in steps:
                before = [c.clone() for c in plain.carry]
                idx_before = plain.carry[18].clone()
                args = (timing,) if timed else ()
                if launch is ks.lane_superstep:
                    _k13_paths(kern, paths)
                launch(kern, *args)
                reference(plain, *args)
                if launch is ks.lane_compact and not torch.equal(
                        idx_before, plain.carry[18]):
                    compacted += 1
                worst = max(worst, _serve_diff(
                    kern, plain, (T_US, T_PREV) if timing
                    and launch is ks.lane_finish else (), before))
        torch.cuda.synchronize()
    check(worst == 0, f"serve kernels differ from their plain versions by "
          f"{worst}")
    check(all(paths.values()), f"K13's paths in the serve cases: {paths}")
    check({0, 1, 2} <= rexecs and compacted > 0,
          f"the serve cases ran rungs {sorted(rexecs)}, {compacted} rebuilds")
    check(killed > 0 and spared > 0, f"the armed serve cases killed "
          f"{killed} lanes and spared {spared} cancelled reset lanes")
    replays = _serve_replays(rng, device)
    check(replays == 0, f"K13/K15 replays differ by {replays}")
    k14 = _k14_cases(device)
    check(k14 == 0, f"K14's cases differ from its plain version by {k14}")
    return worst


# ---- the device-resident carry (B12f): K17-K19 ------------------------------

# (rows, width, lane counts) of the random carry cases: a small class,
# the widest window, the serving class (32 lanes of 4.2 MB), the replay's
# 100k requests (v131072w32), and the 500k strict chain's class
# (v524288w32, 67 MB a lane) at the widths its pools visit: 1 to 4 lanes
# for --speculate-k 3 and the sequential arm, 16 for auto (depth 8)
CARRY_CLASSES = ((2048, 8, (1, 2, 8, 32)), (2048, 1023, (1, 2, 8, 32)),
                 (32768, 32, (1, 2, 8, 32)), (131072, 32, (1, 2, 4, 8)),
                 (524288, 32, (1, 2, 4, 16)))


def phase_carry_kernels(device) -> int:
    """K17-K19 against their plain versions on the card, every output
    exact, on seeded random stacks and carries of ``CARRY_CLASSES`` at
    their lane counts: K17 seating one lane and every lane (in random
    order, one of them twice); K18 keeping no, some and all lanes, ``src``
    and ``dst`` in random order, at the same width, grown ×2 and shrunk
    ÷4; K19 at ×2 and ÷4 with sources past the old width (the dummy);
    from one lane, K18 and K19 also grow to 4 lanes and to the class's
    widest pool (a pool's first wave). Returns the max abs error."""
    from dgc_tpu_torch.kernels import carry as kcar
    from dgc_tpu_torch.layout import CARRY_LEN

    gen = torch.Generator(device=device)
    gen.manual_seed(43)
    rng = np.random.default_rng(43)

    def rand(shape):
        return torch.randint(-(1 << 31), (1 << 31) - 1, shape, generator=gen,
                             dtype=torch.int32, device=device)

    worst, cases = 0, 0
    for v, w, widths in CARRY_CLASSES:
        a0 = v // 4
        for b in widths:
            first = {4, widths[-1]} if b == 1 else set()
            stacks = [rand((b, v, w)), rand((b, v)), rand((b,)), rand((b,)),
                      rand((b,))]
            for lanes in ([int(rng.integers(b))],
                          [int(x) for x in rng.permutation(b)]
                          + [int(rng.integers(b))]):
                n = len(lanes)
                s_comb, s_degrees = rand((n, v, w)), rand((n, v))
                s_k0 = rng.integers(1, 1 << 20, n).tolist()
                s_ms = rng.integers(1, 1 << 20, n).tolist()
                kern = [t.clone() for t in stacks]
                plain = [t.clone() for t in stacks]
                kcar.lane_seat(*kern, lanes, s_comb, s_degrees, s_k0, s_ms)
                kcar.lane_seat_reference(*plain, lanes, s_comb, s_degrees,
                                         s_k0, s_ms)
                worst = max([worst] + [_diff(x, y) for x, y in
                                       zip(kern, plain)])
                cases += 1
            carry = [rand((b, a0) if j == 18 else
                          (b, v) if j in (2, 6, 10) else (b,))
                     for j in range(CARRY_LEN)]
            for b_new in sorted({b, 2 * b, max(1, b // 4)} | first):
                room = min(b, b_new)
                for n_keep in sorted({0, max(1, room // 2), room}):
                    src = [int(x) for x in rng.choice(b, n_keep,
                                                      replace=False)]
                    dst = [int(x) for x in rng.choice(b_new, n_keep,
                                                      replace=False)]
                    got = kcar.carry_permute(carry, src, dst, b_new)
                    want = kcar.carry_permute_reference(carry, src, dst,
                                                        b_new)
                    worst = max([worst] + [_diff(x, y) for x, y in
                                           zip(got, want)])
                    cases += 1
            dummy = rand((v, w))
            for b_new in sorted({2 * b, max(1, b // 4)} | first):
                src = [int(x) for x in rng.integers(0, b + 3, b_new)]
                got = kcar.inputs_resize(*stacks[:4], src, dummy, 1, 777)
                want = kcar.inputs_resize_reference(*stacks[:4], src, dummy,
                                                    1, 777)
                worst = max([worst] + [_diff(x, y) for x, y in
                                       zip(got, want)])
                cases += 1
            torch.cuda.synchronize()
    check(worst == 0, f"the carry kernels differ from their plain versions "
          f"by {worst} over {cases} cases")
    check(all(kcar.launch_counts[k_] > 0 for k_ in _CARRY_KERNELS),
          f"a carry kernel never launched: {kcar.launch_counts}")
    return worst


def _serve_batches():
    """The phase-2 classes: a v8192w32 uniform batch with a forced 3-rung
    ladder and a v2048w1023 RMAT batch with one, each with a dummy lane,
    and a graph to seat mid-ladder."""
    from dgc_tpu_torch.models.generators import (generate_random_graph_fast,
                                                 generate_rmat_graph)
    from dgc_tpu_torch.serve.shape_classes import (ShapeClass, dummy_member,
                                                   pad_member)

    out = []
    for name, cls, graphs, new in (
            ("v8192w32 uniform", ShapeClass(8192, 32),
             [generate_random_graph_fast(n, avg_degree=16, seed=s,
                                         max_degree=32)
              for n, s in ((8000, 1), (6500, 2), (7900, 3))],
             generate_random_graph_fast(7000, avg_degree=12, seed=4,
                                        max_degree=32)),
            ("v2048w1023 rmat", ShapeClass(2048, 1023),
             [generate_rmat_graph(2000, avg_degree=16, seed=s)
              for s in (1, 2)],
             generate_rmat_graph(1800, avg_degree=12, seed=3))):
        members = [pad_member(g, cls) for g in graphs] + [dummy_member(cls)]
        inputs = (np.stack([m.comb for m in members]),
                  np.stack([m.degrees for m in members]),
                  np.array([m.k0 for m in members], np.int32),
                  np.array([m.max_steps for m in members], np.int32))
        out.append((name, cls, inputs, pad_member(new, cls),
                    _serve_ladder(cls.v_pad)))
    return out


def _serve_runs(device, cls, inputs, new_m, stages) -> dict:
    """On ``device``: the unsliced sweep, the sweep in slices of 2, and a
    run that seats ``new_m`` in lane 0 once it left rung 0 (slices of 1,
    then of 2); host copies of every carry slot."""
    from dgc_tpu_torch.layout import CARRY_PHASE, CARRY_RUNG
    from dgc_tpu_torch.serve.batched import (batched_slice, batched_sweep,
                                             idle_carry, stage_idx_width,
                                             to_host)

    b = inputs[1].shape[0]

    def run(inputs, carry, reset, steps, until):
        for _ in range(5000):
            carry = batched_slice(*inputs, reset, carry, planes=cls.planes,
                                  slice_steps=steps, stages=stages,
                                  device=device)
            reset = np.zeros(b, np.int32)
            if until(carry):
                return carry
        raise SmokeFailure("a serve slice loop did not converge")

    done = lambda c: bool((to_host(c[CARRY_PHASE]) >= 2).all())
    sweep = [to_host(o) for o in batched_sweep(*inputs, planes=cls.planes,
                                               stages=stages, device=device)]
    idle = idle_carry(b, cls.v_pad, stage_idx_width(stages))
    sliced = run(inputs, idle, np.ones(b, np.int32), 2, done)
    climbed = run(inputs, idle, np.ones(b, np.int32), 1,
                  lambda c: int(to_host(c[CARRY_RUNG])[0]) > 0)
    swapped = tuple(np.array(x) for x in inputs)
    swapped[0][0], swapped[1][0] = new_m.comb, new_m.degrees
    swapped[2][0], swapped[3][0] = new_m.k0, new_m.max_steps
    reset = np.zeros(b, np.int32)
    reset[0] = 1
    seated = run(swapped, climbed, reset, 2, done)
    new = [to_host(o) for o in batched_sweep(
        new_m.comb[None], new_m.degrees[None], np.array([new_m.k0], np.int32),
        np.array([new_m.max_steps], np.int32), planes=cls.planes,
        stages=stages, device=device)]
    return {"sweep": sweep, "sliced": [to_host(c) for c in sliced],
            "seated": [to_host(c) for c in seated], "new": new}


def phase_serve_engines(device) -> list[dict]:
    """The port's ``batched_sweep`` / ``batched_slice`` on the card
    against the same calls with ``device="cpu"``: every carry slot
    byte-equal (the sweep, slices of 2, a lane seated mid-ladder), the
    sliced sweep equal to the unsliced one, the seated lane equal to its
    graph's own sweep and its co-residents to theirs."""
    from dgc_tpu_torch.layout import N_OUT, OUT0

    rows = []
    for name, cls, inputs, new_m, stages in _serve_batches():
        t = time.perf_counter()
        card = _serve_runs(device, cls, inputs, new_m, stages)
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu = _serve_runs("cpu", cls, inputs, new_m, stages)
        cpu_s = time.perf_counter() - t
        for key in card:
            for j, (a, c) in enumerate(zip(card[key], cpu[key])):
                check(np.array_equal(a, c), f"{name}: {key} slot {j} differs "
                      f"between the card and the CPU")
        for j in range(N_OUT):
            check(np.array_equal(card["sliced"][OUT0 + j], card["sweep"][j]),
                  f"{name}: slices of 2 differ from the sweep in slot {j}")
            check(np.array_equal(card["seated"][OUT0 + j][0],
                                 card["new"][j][0]),
                  f"{name}: the lane seated mid-ladder differs in slot {j}")
            check(np.array_equal(card["seated"][OUT0 + j][1:],
                                 card["sweep"][j][1:]),
                  f"{name}: a co-resident lane differs in slot {j}")
        rows.append({"case": name, "lanes": int(inputs[1].shape[0]),
                     "supersteps": card["sweep"][1].tolist(),
                     "confirm_supersteps": card["sweep"][5].tolist(),
                     "card_s": card_s, "cpu_s": cpu_s})
    return rows


# ---- the serve tier's main path: a request stream through serve_main ---------

# the serving class of dgc_tpu's bench.py --serve-throughput (20k-vertex
# uniform graphs), the staged ladder's deeper rungs (100k vertices, native
# draws) and RMAT graphs past the widest class (the single-graph fallback)
SERVE_STREAM = (
    [{"id": f"u{s}", "node_count": 20000, "max_degree": 32, "seed": s}
     for s in range(32)]
    + [{"id": f"w{s}", "node_count": 100000, "max_degree": 32, "seed": s}
       for s in range(100, 108)]
    + [{"id": f"r{s}", "node_count": 20000, "max_degree": 32, "seed": s,
        "gen_method": "rmat"} for s in range(200, 204)])
SERVE_RUNS = (  # (name, flags, the telemetry files)
    ("continuous, batch 8", ["--batch-max", "8"], False),
    ("sync, batch 8", ["--batch-max", "8", "--serve-mode", "sync"], False),
    ("continuous, batch 32", ["--batch-max", "32"], False),
    ("sync, batch 32", ["--batch-max", "32", "--serve-mode", "sync"], False),
    ("continuous, batch 32, timing", ["--batch-max", "32", "--kernel-timing"],
     True),
    ("continuous, batch 8, device carry", ["--batch-max", "8",
                                           "--device-carry"], False),
)


class _ServeProbe:
    """One ``serve_main`` run, instrumented: the front end it builds,
    each request's attempt tuples, and the copies home from the card
    (``carry_home``, also under ``lanes_home``: one host sync each)."""

    def __enter__(self):
        from dgc_tpu_torch.serve import batched as sb
        from dgc_tpu_torch.serve import engine as se
        from dgc_tpu_torch.serve import queue as sq

        self.fronts, self.attempts, self.homes = [], {}, 0
        self._saved = (sq.ServeFrontEnd.start, sq.ServeFrontEnd._serve_one,
                       se.carry_home)
        start, serve_one, home = self._saved
        probe = self

        def start_(front):
            probe.fronts.append(front)
            return start(front)

        def serve_one_(front, req):
            res = serve_one(front, req)
            probe.attempts[str(req.request_id)] = list(res.attempts)
            return res

        def home_(slots):
            if isinstance(slots[0], torch.Tensor) and slots[0].is_cuda:
                probe.homes += 1
            return home(slots)

        sq.ServeFrontEnd.start = start_
        sq.ServeFrontEnd._serve_one = serve_one_
        se.carry_home = sb.carry_home = home_
        return self

    def __exit__(self, *exc):
        from dgc_tpu_torch.serve import batched as sb
        from dgc_tpu_torch.serve import engine as se
        from dgc_tpu_torch.serve import queue as sq

        (sq.ServeFrontEnd.start, sq.ServeFrontEnd._serve_one,
         se.carry_home) = self._saved
        sb.carry_home = self._saved[2]


def _serve_reference(out_dir: Path, device: str) -> dict:
    """The stream's graphs, drawn as ``serve_main`` draws them, and the
    sequential single-graph loop over them (``dgc_tpu``'s bench.py
    baseline): ``find_minimal_coloring(CompactFrontierEngine(g))`` on the
    card with validation and the post-pass, each coloring saved in the
    coloring schema."""
    from dgc_tpu_torch.engine.compact import CompactFrontierEngine
    from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,
                                                make_reducer, make_validator)
    from dgc_tpu_torch.serve.cli import _load_request_graph

    ref_dir = out_dir / "serve_reference"
    ref_dir.mkdir()
    t = time.perf_counter()
    graphs = {doc["id"]: _load_request_graph(doc) for doc in SERVE_STREAM}
    gen_s = time.perf_counter() - t
    results = {}
    t = time.perf_counter()
    for rid, g in graphs.items():
        attempts = []
        res = find_minimal_coloring(
            CompactFrontierEngine(g.arrays, device=device),
            initial_k=g.max_degree + 1, validate=make_validator(g.arrays),
            on_attempt=lambda r, v, a=attempts: a.append(
                (int(r.k), r.status.name, int(r.supersteps))),
            post_reduce=make_reducer(g.arrays))
        check(res.colors is not None, f"{rid}: no single-graph coloring")
        path = ref_dir / f"{rid}.json"
        g.save_coloring(path, res.colors)
        results[rid] = {"minimal_colors": res.minimal_colors,
                        "attempts": attempts, "coloring": path,
                        "colors": res.colors}
    torch.cuda.synchronize()
    return {"graphs": graphs, "results": results, "gen_s": gen_s,
            "sequential_s": time.perf_counter() - t}


def _serve_events(path: Path) -> list:
    from dgc_tpu_torch.obs.schema import validate_record

    records = [json.loads(x) for x in path.read_text().splitlines()]
    for r in records:
        problems = validate_record(r)
        check(not problems, f"serve event {r} fails the schema: {problems}")
    return records


def _recycled_ids(events: list) -> list:
    """The request id of each ``lane_recycled`` event, in order: the
    trace id (``req-<id>``) of the lane span that ends with it."""
    ids = []
    for e in events:
        if e["event"] == "span" and e["name"] == "lane" and e["ph"] == "E":
            ids.append(e["trace"][len("req-"):])
    return ids


def phase_serve_main(card: str, out_dir: Path, device: str = "cuda") -> dict:
    """``serve_main`` (``python -m dgc_tpu_torch serve``) on the 44-request
    stream, six ways: every request's status, minimal colors,
    ``batched``, ``shape_class``, coloring bytes and attempt tuples equal
    to the single-graph loop's on the card (so equal across the runs); no
    fallback or retry; health not degraded; K13-K16 launched (counts
    zeroed just before each run, read just after); the RMAT requests
    unbatched on ``ell-compact``. Then ``measure_serve``."""
    from dgc_tpu_torch.kernels import carry as kcar
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.kernels import hub as kh
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.kernels import superstep as kss
    from dgc_tpu_torch.serve.batched import _DISPATCH_OVERHEAD_S, _ENTRIES_PER_S
    from dgc_tpu_torch.serve.cli import serve_main
    from dgc_tpu_torch.serve.shape_classes import DEFAULT_LADDER

    ref = _serve_reference(out_dir, device)
    classes = {rid: DEFAULT_LADDER.class_for(g.num_vertices, g.max_degree)
               for rid, g in ref["graphs"].items()}
    check(all((classes[rid] is None) == rid.startswith("r") for rid in
              classes), f"the stream's classes: "
          f"{ {r: c and c.name for r, c in classes.items()} }")
    n = len(SERVE_STREAM)
    emit({"phase": "serve_reference", "requests": n,
          "classes": sorted({c.name for c in classes.values() if c}),
          "rmat_max_degree": [g.max_degree for rid, g in ref["graphs"].items()
                              if classes[rid] is None],
          "gen_s": ref["gen_s"], "sequential_s": ref["sequential_s"],
          "sequential_graphs_per_s": n / ref["sequential_s"],
          "sequential_with_gen_graphs_per_s":
              n / (ref["sequential_s"] + ref["gen_s"]), "card": card})
    runs = {}
    for i, (name, flags, telemetry) in enumerate(SERVE_RUNS):
        d = out_dir / f"serve_run{i}"
        d.mkdir()
        ids = sorted(x["id"] for x in SERVE_STREAM)
        req = d / "requests.jsonl"
        req.write_text("".join(json.dumps(x) + "\n" for x in SERVE_STREAM))
        files = (["--log-json", str(d / "run.jsonl"), "--run-manifest",
                  str(d / "manifest.json"), "--metrics-prom",
                  str(d / "metrics.prom")] if telemetry else [])
        argv = ["--requests", str(req), "--results", str(d / "results.jsonl"),
                "--output-colorings", str(d / "colorings"), "--device", device,
                *flags, *files]
        for m in (ks, kc, kh, kss, kcar):
            m.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        with _ServeProbe() as probe:
            t = time.perf_counter()
            rc = serve_main(argv)
            wall = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = {k_: ks.launch_counts[k_] for k_ in _SERVE_KERNELS}
        carry_launches = {k_: kcar.launch_counts[k_] for k_ in _CARRY_KERNELS}
        timing_launches = dict(ks.timing_launch_counts)
        fallback_launches = {**kc.launch_counts, **kh.launch_counts,
                             **kss.launch_counts}
        check(rc == 0, f"serve {name}: rc {rc}")
        front = probe.fronts[0]
        sst, st = front.scheduler.stats_snapshot(), front.stats_snapshot()
        results = {str(r["id"]): r for r in (json.loads(x) for x in (
            d / "results.jsonl").read_text().splitlines())}
        check(sorted(results) == ids, f"serve {name}: results for "
              f"{sorted(results)}")
        for rid, r in results.items():
            want, cls = ref["results"][rid], classes[rid]
            check(r["status"] == "ok" and r["minimal_colors"] ==
                  want["minimal_colors"], f"serve {name} {rid}: {r} vs "
                  f"{want['minimal_colors']}")
            check(r["batched"] == (cls is not None) and r["shape_class"] ==
                  (cls.name if cls else None), f"serve {name} {rid}: {r}")
            check(filecmp.cmp(r["coloring"], want["coloring"], shallow=False),
                  f"serve {name} {rid}: the coloring differs from the "
                  f"single-graph run's")
            check(probe.attempts[rid] == want["attempts"],
                  f"serve {name} {rid}: attempts {probe.attempts[rid]} vs "
                  f"{want['attempts']}")
        health = front.health()
        metrics = front.registry.to_dict()
        unbatched = sum(classes[rid] is None for rid in ids)
        check(not health["degraded"] and st["fallbacks"] == unbatched,
              f"serve {name}: health {health}, {st['fallbacks']} fallbacks")
        check(not any(k.startswith(("dgc_fallbacks_total",
                                    "dgc_retries_total")) for k in metrics),
              f"serve {name}: a fallback or retry fired")
        check(all(v > 0 for v in launches.values()),
              f"serve {name}: a serve kernel never launched: {launches}")
        check(all(v > 0 for k, v in fallback_launches.items()
                  if k in kc.launch_counts), f"serve {name}: the fallback "
              f"did not run ell-compact on the card: {fallback_launches}")
        check(bool(timing_launches["lane_finish"]) == ("--kernel-timing" in
                                                       flags),
              f"serve {name}: timing launches {timing_launches}")
        check(all((v > 0) == ("--device-carry" in flags)
                  for v in carry_launches.values()),
              f"serve {name}: carry launches {carry_launches}")
        slices = sst["slices"]
        rec = {"phase": "serve_main", "run": name, "argv": flags,
               "requests": len(ids), "wall_s": wall,
               "graphs_per_s": len(ids) / wall,
               "sequential_graphs_per_s": n / ref["sequential_s"],
               "slices": slices, "batches": sst["batches"],
               "recycles": sst["recycles"], "max_live": sst["max_live"],
               "launches": launches, "timing_launches": timing_launches,
               "carry_launches": carry_launches,
               "fallback_launches": fallback_launches,
               "launches_per_slice": ({k: v / slices for k, v in
                                       launches.items()} if slices else None),
               "host_syncs": probe.homes,
               "host_syncs_per_slice": probe.homes / slices if slices else None,
               "h2d_mb": sst["h2d_bytes"] / 1e6,
               "d2h_mb": sst["d2h_bytes"] / 1e6,
               "compile_hits": sst["compile_hits"],
               "compile_misses": sst["compile_misses"],
               "peak_memory_bytes": torch.cuda.max_memory_allocated()
               - base_bytes, "card": card}
        if telemetry:
            events = _serve_events(d / "run.jsonl")
            kinds = {e["event"] for e in events}
            check({"serve_start", "serve_slice", "lane_recycled",
                   "serve_request", "serve_summary"} <= kinds
                  and not kinds & {"fallback", "retry"},
                  f"serve {name}: events {sorted(kinds)}")
            manifest = json.loads((d / "manifest.json").read_text())
            check(manifest["serve"]["summary"]["completed"] == len(ids),
                  f"serve {name}: the manifest's serve summary")
            check("dgc_serve_slices_total" in (d / "metrics.prom").read_text(),
                  f"serve {name}: the metrics file")
            timed = [e for e in events if e["event"] == "serve_slice"
                     and "sstep_ms" in e]
            recycled = [e for e in events if e["event"] == "lane_recycled"]
            check(bool(timed) and bool(recycled)
                  and all("device_us" in e for e in recycled),
                  f"serve {name}: the slices carry no timing")
            # a lane's in-kernel µs over the supersteps of its pair (the
            # sweep call it served: the request's first two attempts)
            steps = {rid: sum(a[2] for a in att[:2])
                     for rid, att in probe.attempts.items()}
            per_step = [e["device_us"] / steps[r] for e, r in zip(
                recycled, _recycled_ids(events)) if steps.get(r)]
            rec["slice_overhead_ms_median"] = float(np.median(
                [e["overhead_ms"] for e in timed]))
            rec["slice_sstep_ms_median"] = float(np.median(
                [e["sstep_ms"] for e in timed]))
            rec["timed_slices"] = len(timed)
            rec["lane_device_us_median"] = float(np.median(
                [e["device_us"] for e in recycled]))
            rec["superstep_us_median"] = (float(np.median(per_step))
                                          if per_step else None)
            rec["recals"] = [e for e in events
                             if e["event"] == "slice_recalibrated"]
            rec["auto_slice_steps_gpu"] = {
                "dispatch_overhead_ms": _DISPATCH_OVERHEAD_S["gpu"] * 1e3,
                "entries_per_s": _ENTRIES_PER_S["gpu"]}
        emit(rec)
        runs[name] = rec
    fronts = _serve_front_runs(card, ref, classes, device)
    meas = measure_serve(card, [g for rid, g in ref["graphs"].items()
                                if rid.startswith("u")], device,
                         wide=[g for rid, g in ref["graphs"].items()
                               if rid.startswith("w")])
    return {"runs": runs, "fronts": fronts, "measure": meas, "ref": ref,
            "classes": classes}


# bench.py's serve-throughput measurement (dgc_tpu's bench.py:184-240):
# the graphs drawn once, then all submitted at once to a front end
SERVE_FRONT_RUNS = (("continuous", 8, False), ("sync", 8, False),
                    ("continuous", 32, False), ("sync", 32, False),
                    ("continuous", 8, True), ("continuous", 32, True))


def _serve_front_runs(card: str, ref: dict, classes: dict,
                      device: str) -> dict:
    """The stream's graphs, drawn once (``_serve_reference``), submitted
    at once to a ``ServeFrontEnd`` of ``workers = batch_max`` (as
    bench.py), in each of ``SERVE_FRONT_RUNS``: every result equal to the
    single-graph loop's (colors, attempts, ``batched``, ``shape_class``);
    graphs/s beside the sequential loop's over the same graphs, lanes
    live at once, slices, launches and host syncs a slice, bytes moved."""
    from dgc_tpu_torch.kernels import carry as kcar
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.serve.queue import ServeFrontEnd

    n = len(ref["graphs"])
    out = {}
    for mode, b, carry in SERVE_FRONT_RUNS:
        ks.reset_launch_counts()
        kcar.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        with _ServeProbe() as probe:
            front = ServeFrontEnd(batch_max=b, workers=b, mode=mode,
                                  queue_depth=max(64, 2 * n),
                                  device_carry=carry, device=device).start()
            t = time.perf_counter()
            tickets = [front.submit(g.arrays, request_id=rid)
                       for rid, g in ref["graphs"].items()]
            results = {str(x.request.request_id): x.result(timeout=900)
                       for x in tickets}
            wall = time.perf_counter() - t
            front.shutdown()
        torch.cuda.synchronize()
        name = f"front end, {mode}, batch {b}" + (", device carry" if carry
                                                  else "")
        for rid, res in results.items():
            want, cls = ref["results"][rid], classes[rid]
            check(res.ok and res.minimal_colors == want["minimal_colors"]
                  and list(res.attempts) == want["attempts"]
                  and np.array_equal(res.colors, want["colors"])
                  and res.batched == (cls is not None)
                  and res.shape_class == (cls.name if cls else None),
                  f"{name} {rid}: {res.status} {res.minimal_colors} "
                  f"{res.attempts} vs {want['minimal_colors']} "
                  f"{want['attempts']}")
        check(not front.health()["degraded"], f"{name}: degraded")
        launches = {k_: ks.launch_counts[k_] for k_ in _SERVE_KERNELS}
        check(all(v > 0 for v in launches.values()),
              f"{name}: a serve kernel never launched: {launches}")
        carry_launches = {k_: kcar.launch_counts[k_] for k_ in _CARRY_KERNELS}
        check(all((v > 0) == carry for v in carry_launches.values()),
              f"{name}: carry launches {carry_launches}")
        sst = front.scheduler.stats_snapshot()
        slices = sst["slices"]
        rec = {"phase": "serve_front", "run": name, "wall_s": wall,
               "graphs_per_s": n / wall,
               "sequential_graphs_per_s": n / ref["sequential_s"],
               "speedup": ref["sequential_s"] / wall,
               "slices": slices, "batches": sst["batches"],
               "max_live": sst["max_live"], "recycles": sst["recycles"],
               "launches": launches, "carry_launches": carry_launches,
               "launches_per_slice": ({k: v / slices for k, v in
                                       launches.items()} if slices else None),
               "host_syncs": probe.homes,
               "host_syncs_per_slice": probe.homes / slices if slices else None,
               "h2d_mb": sst["h2d_bytes"] / 1e6,
               "d2h_mb": sst["d2h_bytes"] / 1e6,
               "peak_memory_bytes": torch.cuda.max_memory_allocated()
               - base_bytes, "card": card}
        emit(rec)
        out[name] = rec
    return out


def _serve_lanes_of(inputs, cls, stages, device, budget: int,
                    armed: bool = False):
    """Lanes for a fresh sweep of ``inputs`` (every lane flagged); with
    ``armed``, the speculation vectors: every other lane spec-tagged (an
    attempt-only lane), every cancel bit set (a flagged lane is never
    killed)."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.layout import CARRY_IDX, CARRY_LEN, CARRY_P1, CARRY_P2
    from dgc_tpu_torch.serve.batched import _ladder_ctrl, resolve_stages

    b, v = inputs[1].shape
    _st, _pads, a0 = resolve_stages(stages, v)
    carry = [torch.empty((b, a0) if j == CARRY_IDX else
                         (b, v) if j in (2, CARRY_P1, CARRY_P2) else (b,),
                         dtype=torch.int32, device=device)
             for j in range(CARRY_LEN)]
    t = lambda x: x.to(device).clone()
    L = ks.new_lanes(carry, t(inputs[0]), t(inputs[1]), t(inputs[2]),
                     t(inputs[3]), torch.ones(b, dtype=torch.int32,
                                              device=device),
                     _ladder_ctrl(resolve_stages(stages, v)[0], device),
                     planes=cls.planes, stall_window=64, budget=budget)
    if armed:
        L.arm_spec(torch.arange(b, dtype=torch.int32, device=device) % 2,
                   torch.ones(b, dtype=torch.int32, device=device))
    return L


def _serve_bytes(L, kind: str, before: dict) -> int:
    """The bytes one launch must move (each input read once, each output
    written once), from the lanes' state before it (``before``: host
    copies of ctrl, phase, reset, idx, idx_rung, degrees) and after it."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.serve.batched import to_host

    b, v, a0 = L.b, L.v, L.a0
    ctrl, phase = before["ctrl"], before["phase"]
    live = phase < 2
    pad = ctrl[ks.CTRL_PAD0 + ctrl[ks.CTRL_REXEC]]
    scalars = 4 * 20 * b
    if kind == "lane_reset":
        # _fresh_lanes: a flagged lane's degrees read, its packed, p1, p2
        # and slot list written; the others' scalars only; the spec and
        # cancel vectors read when armed
        return (int((before["reset"] != 0).sum()) * (4 * v + a0) * 4 + scalars
                + (8 * b if L.armed else 0))
    if kind == "lane_compact":
        need = live & (before["idx_rung"] < ctrl[ks.CTRL_REXEC]) & (pad > 0)
        return int(need.sum()) * (v + a0) * 4 + 4 * b
    rows = []  # each live lane's evaluated rows
    for lane in np.flatnonzero(live):
        if pad == 0:
            rows.append(np.arange(v))
        else:
            sl = before["idx"][lane, :pad]
            rows.append(sl[sl < v])
    if kind == "lane_superstep":
        # a lane's rows that are not confirmed: their real entries, their
        # degrees and their new words; the lane's state read once, the
        # slot list of a staged rung
        deg, pk = before["degrees"], before["packed"]
        total = scalars
        for lane, r in zip(np.flatnonzero(live), rows):
            me = pk[lane, r]
            walked = r[(me < 0) | ((me & 1) == 1)]
            total += (int(deg[lane, walked].sum()) + 2 * len(walked) + v
                      + (pad or 0)) * 4
        return total
    if kind == "lane_superstep_all_rows":
        # the bound before PR 18: every evaluated row's real entries
        deg = before["degrees"]
        return sum((int(deg[lane, r].sum()) + len(r) + v + (pad or 0)) * 4
                   for lane, r in zip(np.flatnonzero(live), rows)) + scalars
    # lane_finish: a lane that ended its attempt (step back to 1) writes
    # its result row and re-inits both buffers
    fin = live & (to_host(L.carry[3]) == 1)
    total = scalars
    for lane, r in zip(np.flatnonzero(live), rows):
        total += (5 * v if fin[lane] else
                  2 * v if pad == 0 else (pad + 2 * len(r))) * 4
    return total


_SERVE_KERNELS = ("lane_reset", "lane_compact", "lane_superstep",
                  "lane_finish")
# the unsharded pool's K17-K19 (the lane mesh's instances apart)
_CARRY_KERNELS = ("lane_seat", "carry_permute", "inputs_resize")
_SERVE_NAMES = {name: f"{name}_kernel" for name in _SERVE_KERNELS}


def _serve_state(L) -> dict:
    from dgc_tpu_torch.serve.batched import to_host

    return {"ctrl": L.ctrl.tolist(), "phase": to_host(L.carry[0]).copy(),
            "packed": to_host(L.carry[2]).copy(),
            "reset": to_host(L.reset).copy(),
            "idx": to_host(L.carry[18]).copy(),
            "idx_rung": to_host(L.carry[17]).copy(),
            "degrees": to_host(L.degrees).copy()}


def _serve_sweep(L, staged: bool, timing: bool) -> None:
    """K16, then rounds of K14?/K13/K15 until no lane runs (one read of
    the live word a round: no launch after the last live superstep)."""
    from dgc_tpu_torch.kernels import serve as ks

    ks.lane_reset(L, timing)
    while int(L.ctrl[ks.CTRL_LIVE]):
        if staged:
            ks.lane_compact(L)
        ks.lane_superstep(L)
        ks.lane_finish(L, timing)


def _held_serve_sweep(inputs, cls, stages, device, timing: bool,
                      armed: bool = False) -> dict:
    """One sweep of ``inputs`` with every launch held against its plain
    version on the card (``_serve_diff``: every buffer exact, the clock
    slots of the kTiming instances by rule), the plain version timed
    (``plain_s``) and the bytes each launch must move counted from the
    state before it (``bytes``), K13's paths from its plans
    (``k13_paths``, ``_k13_paths``); ``library_ms``: ``torch.nonzero`` on
    the active rows of the lanes K14 rebuilds first."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.layout import T_PREV, T_US

    pairs = {"lane_reset": (ks.lane_reset, ks.lane_reset_reference),
             "lane_compact": (ks.lane_compact, ks.lane_compact_reference),
             "lane_superstep": (ks.lane_superstep,
                                ks.lane_superstep_reference),
             "lane_finish": (ks.lane_finish, ks.lane_finish_reference)}
    clocks = {"lane_reset": (T_PREV,), "lane_finish": (T_US, T_PREV)}
    kern = _serve_lanes_of(inputs, cls, stages, device, ks.INT32_MAX, armed)
    plain = _serve_lanes_of(inputs, cls, stages, device, ks.INT32_MAX, armed)
    out = {"worst": 0, "rounds": 0, "library_ms": None,
           "bytes": {k: [] for k in _SERVE_KERNELS},
           "plain_s": {k: [] for k in _SERVE_KERNELS},
           "k13_all_rows_bytes": [],
           "k13_paths": {"shared": 0, "global": 0, "wide": 0}}

    def held(name):
        before = _serve_state(plain)
        launch, reference = pairs[name]
        args = (timing,) if name in clocks else ()
        clock = clocks.get(name, ()) if timing else ()
        carry_before = [c.clone() for c in plain.carry]
        if name == "lane_compact" and out["library_ms"] is None:
            s_ = before["ctrl"][ks.CTRL_REXEC]
            need = ((before["phase"] < 2) & (before["idx_rung"] < s_)
                    & (before["ctrl"][ks.CTRL_PAD0 + s_] > 0))
            if need.any():
                pk = kern.carry[2][torch.from_numpy(need).to(device)]
                act = (pk < 0) | ((pk & 1) == 1)
                out["library_ms"] = _cuda_ms(lambda: torch.nonzero(act), 20)
        if name == "lane_superstep":
            _k13_paths(kern, out["k13_paths"])
        launch(kern, *args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        reference(plain, *args)
        torch.cuda.synchronize()
        out["plain_s"][name].append(time.perf_counter() - t)
        out["bytes"][name].append(_serve_bytes(plain, name, before))
        if name == "lane_superstep":
            out["k13_all_rows_bytes"].append(_serve_bytes(
                plain, "lane_superstep_all_rows", before))
        out["worst"] = max(out["worst"], _serve_diff(kern, plain, clock,
                                                     carry_before))

    held("lane_reset")
    while int(plain.ctrl[ks.CTRL_LIVE]):
        for name in (["lane_compact"] if stages is not None else []) + [
                "lane_superstep", "lane_finish"]:
            held(name)
        out["rounds"] += 1
    return out


def _serve_inputs(graphs: list, device) -> tuple:
    """(class, its auto ladder, the stacked inputs) of ``graphs`` padded
    into their class, one lane each."""
    from dgc_tpu_torch.serve.shape_classes import (DEFAULT_LADDER,
                                                   pad_member,
                                                   stage_schedule_for)

    cls = DEFAULT_LADDER.class_for(max(g.num_vertices for g in graphs),
                                   max(g.max_degree for g in graphs))
    members = [pad_member(g.arrays, cls) for g in graphs]
    inputs = tuple(torch.from_numpy(np.stack(x)).to(device) for x in (
        [m.comb for m in members], [m.degrees for m in members],
        [np.int32(m.k0) for m in members],
        [np.int32(m.max_steps) for m in members]))
    return cls, stage_schedule_for(cls, "auto"), inputs


def _serve_global(graphs: list, device) -> dict:
    """K13's global path (a class past 32,768 rows: no lane state staged)
    on the 8 100k requests (v131072w32), one lane each: one sweep held
    launch by launch; K13's and K15's plain time and bound a launch
    (``tools/kernel_costs.py k13`` times the same sweep on the card)."""
    cls, stages, inputs = _serve_inputs(graphs, device)
    held = _held_serve_sweep(inputs, cls, stages, device, False)
    rounds = held["rounds"]
    check(held["k13_paths"]["wide"] == rounds,
          f"K13 on {cls.name}: paths {held['k13_paths']} in {rounds} rounds")
    mean = lambda xs: sum(xs) / len(xs)
    out = {"class": cls.name, "lanes": inputs[1].shape[0], "rounds": rounds,
           "max_abs_err": held["worst"]}
    for name in ("lane_superstep", "lane_finish"):
        out[name] = {"plain_ms": mean(held["plain_s"][name]) * 1e3,
                     "bound_ms": mean(held["bytes"][name])
                     / HBM_BYTES_PER_S * 1e3, "held_launches": rounds}
    return out


def measure_serve(card: str, graphs: list, device: str = "cuda",
                  wide: list | None = None) -> dict:
    """K13-K16 at the serving class's shapes: the 32 uniform 20k requests
    padded into their class (v32768w32, the auto ladder), one lane each.
    (1) Held sweeps (``_held_serve_sweep``), timing off and on: every
    launch held against its plain version on the card (``plain_ms``),
    the bytes it must move (``bound_ms``). (2) The same sweeps under
    ``torch.profiler``: each kernel's device time a launch (``ms``), the
    kTiming instances' from the timing sweep. (3) Slices as the scheduler
    runs them (``_serve_slices``): host wall against device busy. (4)
    ``torch.nonzero`` on the active rows of the lanes K14 rebuilt first
    (``library_ms``). (5) K13's paths from its plans: both must run. (6)
    With ``wide`` (the 100k requests), ``_serve_global``: K13's path
    without a staged lane state."""
    from dgc_tpu_torch.kernels import serve as ks

    cls, stages, inputs = _serve_inputs(graphs, device)
    lanes = len(graphs)
    staged = stages is not None
    held = {t: _held_serve_sweep(inputs, cls, stages, device, t)
            for t in (False, True)}
    held["spec"] = _held_serve_sweep(inputs, cls, stages, device, False,
                                     armed=True)
    worst = max(h["worst"] for h in held.values())
    rounds = held[False]["rounds"]
    check(worst == 0 and held[True]["rounds"] == rounds,
          f"the held serve sweeps differ from the plain versions by {worst} "
          f"(rounds {rounds}, timing {held[True]['rounds']})")

    want = {"lane_reset": 1, "lane_compact": rounds if staged else 0,
            "lane_superstep": rounds, "lane_finish": rounds}
    prof = {t: _profiled(
        lambda L, t=t: _serve_sweep(L, staged, t), want, _DEVICE_MS_KEPT,
        _SERVE_NAMES, prepare=lambda: _serve_lanes_of(
            inputs, cls, stages, device, ks.INT32_MAX)) for t in (False, True)}
    spec_rounds = held["spec"]["rounds"]
    prof["spec"] = _profiled(
        lambda L: _serve_sweep(L, staged, False),
        {"lane_reset": 1, "lane_compact": spec_rounds if staged else 0,
         "lane_superstep": spec_rounds, "lane_finish": spec_rounds},
        _DEVICE_MS_KEPT, _SERVE_NAMES, prepare=lambda: _serve_lanes_of(
            inputs, cls, stages, device, ks.INT32_MAX, armed=True))
    slices = _serve_slices(inputs, cls, stages, device)
    mean = lambda xs: sum(xs) / len(xs) if xs else None
    rec = {"phase": "serve_measure", "class": cls.name, "lanes": lanes,
           "stages": [list(s) for s in stages] if stages else None,
           "rounds": rounds, "max_abs_err": worst, "slices": slices,
           "card": card}
    for name in _SERVE_KERNELS:
        nbytes = held[False]["bytes"][name]
        if not nbytes:
            continue
        t_off, n_off, each = prof[False][name]
        rec[name] = {
            "held_launches": len(nbytes),
            "ms": t_off / n_off if n_off else None,
            "first_ms": each[0] if each else None,
            "max_ms": max(each) if each else None,
            "first_bound_ms": nbytes[0] / HBM_BYTES_PER_S * 1e3,
            # the launches that moved more than the per-lane flags (K14:
            # the rebuilds), where the profile kept every launch
            "working_ms": (mean([t_ for t_, b_ in zip(each, nbytes)
                                 if b_ > 4 * lanes])
                           if len(each) == len(nbytes) else None),
            "working_bound_ms": mean([b_ for b_ in nbytes
                                      if b_ > 4 * lanes] or [0])
            / HBM_BYTES_PER_S * 1e3,
            "plain_ms": mean(held[False]["plain_s"][name]) * 1e3,
            "bound_ms": mean(nbytes) / HBM_BYTES_PER_S * 1e3,
            "bytes_per_launch": mean(nbytes),
            "library_ms": (held[False]["library_ms"]
                           if name == "lane_compact" else None)}
        if name in ("lane_reset", "lane_finish"):
            t_on, n_on, _each = prof[True][name]
            nbytes_on = held[True]["bytes"][name]
            rec[name].update({
                "timing_ms": t_on / n_on if n_on else None,
                "timing_plain_ms": mean(held[True]["plain_s"][name]) * 1e3,
                "timing_bound_ms": mean(nbytes_on) / HBM_BYTES_PER_S * 1e3,
                "timing_held_launches": len(nbytes_on)})
            t_sp, n_sp, _each = prof["spec"][name]
            nbytes_sp = held["spec"]["bytes"][name]
            rec[name].update({
                "spec_ms": t_sp / n_sp if n_sp else None,
                "spec_plain_ms": mean(held["spec"]["plain_s"][name]) * 1e3,
                "spec_bound_ms": mean(nbytes_sp) / HBM_BYTES_PER_S * 1e3,
                "spec_held_launches": len(nbytes_sp)})
    rec["spec_rounds"] = spec_rounds
    # the full table's blocks gather from the staged state, a deep rung's
    # from device memory
    paths = held[False]["k13_paths"]
    rec["lane_superstep"]["paths"] = paths
    check(paths["shared"] > 0 and paths["global"] > 0,
          f"K13's paths over the {cls.name} sweep: {paths}")
    k13_all = held[False]["k13_all_rows_bytes"]
    rec["lane_superstep"]["bound_all_rows_ms"] = (
        mean(k13_all) / HBM_BYTES_PER_S * 1e3)
    if wide:
        rec["global"] = _serve_global(wide, device)
        worst = max(worst, rec["global"]["max_abs_err"])
        rec["max_abs_err"] = worst
        check(worst == 0, f"K13's global path differs from its plain version "
              f"by {worst}")
    emit(rec)
    return rec


def _serve_slices(inputs, cls, stages, device, n: int = 2) -> list:
    """The first ``n`` slices of ``inputs`` as the scheduler runs them,
    each under ``torch.profiler`` (``_profiled``): the first makes the
    lanes from an idle carry (``slice_lanes``), each later one writes the
    scheduling vectors into the kept lanes; then ``run_slice`` at the
    priced slice size and the one read of the scheduling scalars. Host
    wall against device busy. A window is taken again from the same
    state; one that kept ``_DEVICE_MS_KEPT`` of the launches is taken,
    its busy time a lower bound (``kept`` says how many)."""
    from dgc_tpu_torch.serve.batched import (auto_slice_steps, carry_home,
                                             idle_carry, is_staged,
                                             run_slice, slice_lanes,
                                             stage_idx_width)

    b = inputs[1].shape[0]
    steps = auto_slice_steps(cls.entries(), b, "gpu")
    staged = is_staged(stages)
    want = {"lane_reset": 1, "lane_compact": steps if staged else 0,
            "lane_superstep": steps, "lane_finish": steps}
    launches = sum(want.values())
    k0, max_steps = (x.cpu().numpy() for x in inputs[2:4])
    state = {}
    out = []
    for i in range(n):
        reset = np.full(b, 1 if i == 0 else 0, np.int32)
        saved = (None if i == 0 else
                 [t.clone() for t in state["L"].carry + [state["L"].nxt]])

        def prepare():
            if saved is not None:  # the slice's start, in the same tensors
                for t, s_ in zip(state["L"].carry + [state["L"].nxt], saved):
                    t.copy_(s_)
            torch.cuda.synchronize()

        def one_slice(_arg, i=i, reset=reset):
            t = time.perf_counter()
            host = torch.from_numpy(np.stack([k0, max_steps, reset]))
            if i == 0:
                vecs = host.to(device, copy=True)
                L = slice_lanes(inputs[0], inputs[1], vecs[0], vecs[1],
                                vecs[2], idle_carry(b, cls.v_pad,
                                                    stage_idx_width(stages)),
                                planes=cls.planes, stages=stages,
                                device=device)
            else:
                L = state["L"]
                state["vecs"].copy_(host)
                vecs = state["vecs"]
            nxt = run_slice(L, slice_steps=steps, staged=staged)
            home = carry_home([nxt[0], nxt[3], nxt[15]])
            state.update(L=L, vecs=vecs, home=home,
                         wall=time.perf_counter() - t)

        prof = _profiled(one_slice, want, _DEVICE_MS_KEPT,
                         dict(_SERVE_NAMES, busy=""), prepare=prepare)
        kept = sum(prof[k][1] for k in want)
        home, wall = state["home"], state["wall"]
        busy = prof["busy"][0]
        out.append({"slice": i, "slice_steps": steps, "launches": launches,
                    "kept": kept,
                    "wall_ms": wall * 1e3, "busy_ms": busy,
                    "idle_share": 1 - busy / (wall * 1e3),
                    "phases": sorted(set(home[0].tolist())),
                    "steps_max": int(home[1].max()),
                    "rungs": sorted(set(home[2].tolist()))})
    return out


def serve_kernels_line(serve: dict, serve_err: int) -> list[dict]:
    """K13-K16 on the serve replay's main path: launches from the default
    run (continuous, batch 8; the other runs' beside), times from
    ``measure_serve`` at the serving class's shapes (with the launches of
    the sweep they were measured on, ``timed_sweep_launches``); the kTiming
    instances of K15 and K16 with the timing run's launches and their own
    times, plain times and bounds from the timing sweep."""
    runs, meas = serve["runs"], serve["measure"]
    main = runs["continuous, batch 8"]
    timed = runs["continuous, batch 32, timing"]
    err = max(serve_err, meas["max_abs_err"])
    source = "dgc_tpu_torch/csrc/serve.cu"
    replaces = {"lane_superstep": "dgc_tpu/serve/batched.py:282",
                "lane_compact": "dgc_tpu/serve/batched.py:268",
                "lane_finish": "dgc_tpu/serve/batched.py:363",
                "lane_reset": "dgc_tpu/serve/batched.py:202"}
    out = []
    for name in ("lane_superstep", "lane_compact", "lane_finish",
                 "lane_reset"):
        m = meas[name]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces[name],
               "launches": main["launches"][name],
               "launches_other": {r: v["launches"][name]
                                  for r, v in runs.items()
                                  if v is not main},
               # in the measured sweep, the run the time is from
               "timed_sweep_launches": m["held_launches"],
               "max_abs_err": err, "ms": m["ms"],
               "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
               "bound_by": "bytes", "library_ms": m["library_ms"]}
        if name == "lane_superstep":
            # the full table (the sweep's first launch), the bound counting
            # every evaluated row, and the path without a staged state
            row.update(full_table_ms=m["first_ms"],
                       full_table_bound_ms=m["first_bound_ms"],
                       bound_all_rows_ms=m["bound_all_rows_ms"],
                       paths=m["paths"])
        if "global" in meas and name in meas["global"]:
            g = meas["global"]
            row["global"] = {"class": g["class"], "lanes": g["lanes"],
                             **g[name]}
        out.append(row)
    for name in ("lane_finish", "lane_reset"):
        m = meas[name]
        out.append({"name": f"{name}_timing", "route": "cuda",
                    "source": source,
                    "replaces": ("dgc_tpu/serve/batched.py:414"
                                 if name == "lane_finish" else
                                 "dgc_tpu/serve/batched.py:512"),
                    "launches": timed["timing_launches"][name],
                    "max_abs_err": err, "ms": m["timing_ms"],
                    "plain_ms": m["timing_plain_ms"],
                    "bound_ms": m["timing_bound_ms"],
                    "bound_by": "bytes", "library_ms": None,
                    "off_ms": m["ms"]})
    return out


# ---- phase 2: the device carry and speculation against the CPU --------------

def _carry_stream():
    """The device-carry scheduler's stream: 41 uniform graphs of class
    v2048w16, the first (the largest) alone, then 7, then 33, so the pool
    grows 1 → 8 → 32 with live lanes kept and shrinks as it drains."""
    from dgc_tpu_torch.models.generators import generate_random_graph_fast

    sizes = [2000] + [1900 - 20 * i for i in range(40)]
    graphs = [generate_random_graph_fast(n, avg_degree=10, seed=700 + i,
                                         max_degree=16)
              for i, n in enumerate(sizes)]
    return graphs, (1, 8, 41)


def _scheduled(device, graphs, waves, **kw) -> tuple:
    """``graphs`` through a continuous ``BatchScheduler`` on ``device``
    (``kw`` its options), each a jump sweep on its own thread, the waves
    (cumulative counts) each started once the ones before it were live in
    the pool together (``max_live``). Returns (attempt tuples and colors of each graph,
    the scheduler's stats, its serve_slice events)."""
    import threading

    from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,
                                                make_reducer, make_validator)
    from dgc_tpu_torch.serve.engine import BatchMemberEngine, BatchScheduler
    from dgc_tpu_torch.serve.shape_classes import DEFAULT_LADDER, pad_member

    events = []
    sched = BatchScheduler(device=device, window_s=0.0, on_event=lambda k_, r:
                           events.append((k_, r)), **kw).start()
    out = {}

    def run(i, g):
        cls = DEFAULT_LADDER.class_for(g.num_vertices, g.max_degree)
        attempts = []
        res = find_minimal_coloring(
            BatchMemberEngine(pad_member(g, cls), sched),
            initial_k=g.max_degree + 1, validate=make_validator(g),
            on_attempt=lambda r, v: attempts.append(
                (int(r.k), r.status.name, int(r.supersteps))),
            post_reduce=make_reducer(g))
        out[i] = (attempts, res.colors)

    threads = [threading.Thread(target=run, args=(i, g))
               for i, g in enumerate(graphs)]
    try:
        start = 0
        for end in waves:
            deadline = time.perf_counter() + 30
            while (start and sched.stats_snapshot()["max_live"] < start
                   and time.perf_counter() < deadline):
                time.sleep(0.0005)
            for t in threads[start:end]:
                t.start()
            start = end
        for t in threads:
            t.join(timeout=600)
    finally:
        sched.stop()
    check(len(out) == len(graphs), f"{len(out)} of {len(graphs)} sweeps "
          f"came back")
    return out, sched.stats_snapshot(), [r for k_, r in events
                                         if k_ == "serve_slice"]


def phase_carry_engines(device) -> dict:
    """The scheduler with ``device_carry=True`` on the card against its
    ``device="cpu"`` run on ``_carry_stream`` (32 lanes at most, slices of
    2): every graph's attempt tuples and colors equal; the card's pool
    visits widths 1, 8 and 32 and shrinks, K17-K19 launch (counts zeroed
    just before the card's run), and each slice's d2h is the scheduling
    scalars and the finished lanes' result rows."""
    from dgc_tpu_torch.kernels import carry as kcar

    graphs, waves = _carry_stream()
    kw = dict(batch_max=32, slice_steps=2, device_carry=True)
    kcar.reset_launch_counts()
    t = time.perf_counter()
    card, stats, slices = _scheduled(device, graphs, waves, **kw)
    card_s = time.perf_counter() - t
    launches = {k_: kcar.launch_counts[k_] for k_ in _CARRY_KERNELS}
    t = time.perf_counter()
    cpu, _stats, _slices = _scheduled("cpu", graphs, waves, **kw)
    cpu_s = time.perf_counter() - t
    for i in card:
        check(card[i][0] == cpu[i][0] and np.array_equal(card[i][1],
                                                          cpu[i][1]),
              f"device carry: graph {i} differs between the card and the "
              f"CPU: {card[i][0]} vs {cpu[i][0]}")
    widths = [r["b_pad"] for r in slices]
    check({1, 8, 32} <= set(widths) and any(
        b_ < a_ for a_, b_ in zip(widths, widths[1:])),
        f"device carry: the pool's widths {sorted(set(widths))}")
    check(all(v_ > 0 for v_ in launches.values()),
          f"device carry: a carry kernel never launched: {launches}")
    check(all(r["d2h_bytes"] == (3 * r["b_pad"] + r["done"] * (2 * 2048 + 5))
              * 4 for r in slices), "device carry: a slice's d2h bytes")
    rec = {"phase": "carry_engines", "graphs": len(graphs),
           "widths": sorted(set(widths)), "slices": stats["slices"],
           "launches": launches, "h2d_mb": stats["h2d_bytes"] / 1e6,
           "d2h_mb": stats["d2h_bytes"] / 1e6, "card_s": card_s,
           "cpu_s": cpu_s}
    emit(rec)
    return rec


SPEC_V = 20000  # the speculation engines' graphs


def phase_speculate_engines(device) -> dict:
    """A strict ``SpeculativeMinimalKEngine`` sweep at depth 3 of a 20k
    uniform graph (class v32768w32) on a 4-lane device-carry pool of the
    card in slices of one superstep, with five jump-mode requests of the
    same class (padded beforehand) submitted from the dispatcher's third
    ``spec_seated`` event, which waits until all five are queued: the
    slice entry after it finds more real calls than free lanes beside the
    window's unclaimed lanes, so real requests preempt speculative lanes
    whatever the threads' timing. The strict chain's attempts and colors
    equal the sequential strict run's (``CompactFrontierEngine``, on the
    card), each request's its own single-graph run's."""
    import threading

    from dgc_tpu_torch.engine.compact import CompactFrontierEngine
    from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,
                                                make_reducer, make_validator)
    from dgc_tpu_torch.models.generators import generate_random_graph_fast
    from dgc_tpu_torch.serve.engine import BatchMemberEngine, BatchScheduler
    from dgc_tpu_torch.serve.shape_classes import DEFAULT_LADDER, pad_member
    from dgc_tpu_torch.serve.speculate import SpeculativeMinimalKEngine

    graphs = [generate_random_graph_fast(SPEC_V - 500 * i, avg_degree=16,
                                         seed=800 + i, max_degree=32)
              for i in range(6)]

    def sweep(engine, g, strict):
        attempts = []
        res = find_minimal_coloring(
            engine, initial_k=g.max_degree + 1, strict_decrement=strict,
            validate=make_validator(g),
            on_attempt=lambda r, v: attempts.append(
                (int(r.k), r.status.name, int(r.supersteps))),
            post_reduce=make_reducer(g))
        return attempts, res.colors

    want = [sweep(CompactFrontierEngine(g, device=device), g, i == 0)
            for i, g in enumerate(graphs)]
    cls = DEFAULT_LADDER.class_for(graphs[0].num_vertices,
                                   graphs[0].max_degree)
    members = [pad_member(g, cls) for g in graphs]
    got = {}

    def jump(i):
        got[i] = sweep(BatchMemberEngine(members[i], sched), graphs[i],
                       False)

    jumps = [threading.Thread(target=jump, args=(i,))
             for i in range(1, len(graphs))]
    seats = []

    def queued() -> int:
        with sched._lock:
            return sum(1 for c in sched._pending.get(cls, ())
                       if not c.attempt_only)

    def on_event(kind, rec):
        # on the dispatcher's thread, between the window's seats and its
        # slice: the third seat starts the jump requests and holds the
        # dispatcher until they are queued
        if kind != "spec_seated" or len(seats) >= 3:
            return
        seats.append(rec["k"])
        if len(seats) < 3:
            return
        for th in jumps:
            th.start()
        deadline = time.perf_counter() + 120
        while queued() < len(jumps) and time.perf_counter() < deadline:
            time.sleep(0.0005)

    sched = BatchScheduler(batch_max=4, window_s=0.0, slice_steps=1,
                           device=device, device_carry=True,
                           on_event=on_event).start()
    try:
        spec = SpeculativeMinimalKEngine(members[0], sched, depth=3)

        def strict():
            try:
                got[0] = sweep(spec, graphs[0], True)
            finally:
                spec.close()

        chain = threading.Thread(target=strict)
        chain.start()
        chain.join(timeout=600)
        for th in jumps:
            if th.ident is not None:   # started by the third seat
                th.join(timeout=600)
        stats = sched.stats_snapshot()
    finally:
        sched.stop()
    for i, (attempts, colors) in enumerate(want):
        check(i in got and got[i][0] == attempts
              and np.array_equal(got[i][1], colors),
              f"speculation: graph {i} differs from its sequential run: "
              f"{got.get(i, (None,))[0]} vs {attempts}")
    check(stats["spec_preempted"] > 0 and stats["spec_wins"] > 0,
          f"speculation: no preemption or no claim: {stats}")
    rec = {"phase": "speculate_engines", "strict_attempts": len(want[0][0]),
           **{k_: v_ for k_, v_ in stats.items() if k_.startswith("spec_")},
           "claims": spec.spec_stats}
    emit(rec)
    return rec



# ---- phase 3: speculative minimal-k at 500k ---------------------------------

# a 500,000-vertex uniform native draw (class v524288w32, 67 MB a lane),
# strict from k0 = 33
SPEC_ARGS = ["--node-count", "500000", "--max-degree", "32", "--gen-method",
             "fast", "--seed", "0", "--strict-decrement"]
SPEC_ARMS = (  # (name, the CLI's extra flags; None: the serve pool's
               # sequential arm, driven below)
    ("plain strict, ell-compact", []),
    ("serve pool, sequential", None),
    ("speculate-k 3", ["--speculate-k", "3"]),
    ("speculate-k auto", ["--speculate-k", "auto"]),
)


class _SpecProbe:
    """One run's speculative engines' ``spec_stats`` (at ``close``), its
    schedulers' stats (at ``stop``) and the wall of each of the CLI's
    ``find_minimal_coloring`` calls (the sweep: attempts, validation,
    post-pass)."""

    def __enter__(self):
        from dgc_tpu_torch import cli
        from dgc_tpu_torch.serve import engine as se
        from dgc_tpu_torch.serve import speculate as sp

        self.spec, self.sched, self.sweeps = [], [], []
        self._saved = (sp.SpeculativeMinimalKEngine.close,
                       se.BatchScheduler.stop, cli.find_minimal_coloring)
        close, stop, find = self._saved
        probe = self

        def find_(*a, **kw):
            t = time.perf_counter()
            res = find(*a, **kw)
            probe.sweeps.append(time.perf_counter() - t)
            return res

        def close_(engine):
            close(engine)
            probe.spec.append(dict(engine.spec_stats))

        def stop_(sched):
            probe.sched.append(sched.stats_snapshot())
            return stop(sched)

        sp.SpeculativeMinimalKEngine.close = close_
        se.BatchScheduler.stop = stop_
        cli.find_minimal_coloring = find_
        return self

    def __exit__(self, *exc):
        from dgc_tpu_torch import cli
        from dgc_tpu_torch.serve import engine as se
        from dgc_tpu_torch.serve import speculate as sp

        (sp.SpeculativeMinimalKEngine.close, se.BatchScheduler.stop,
         cli.find_minimal_coloring) = self._saved


def _serve_sequential_arm(path: Path, depth: int, device: str) -> tuple:
    """The speculation A/B's sequential arm: the strict chain through a
    pool of the same width as the window's (``depth + 1`` lanes, the carry
    on the card), one ``single_attempt`` a budget
    (``ServeSequentialMinimalKEngine``), the CLI's validation and
    post-pass; the coloring saved to ``path``. Returns (attempt tuples,
    sweep seconds, scheduler stats)."""
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.engine.minimal_k import (find_minimal_coloring,
                                                make_reducer, make_validator)
    from dgc_tpu_torch.serve.engine import BatchScheduler
    from dgc_tpu_torch.serve.shape_classes import DEFAULT_LADDER, pad_member
    from dgc_tpu_torch.serve.speculate import ServeSequentialMinimalKEngine

    args = cli.build_parser().parse_args(SPEC_ARGS + ["--output-coloring",
                                                      str(path)])
    graph = cli.load_graph(args)
    cls = DEFAULT_LADDER.class_for(graph.num_vertices, graph.max_degree)
    sched = BatchScheduler(batch_max=depth + 1, device=device,
                           device_carry=True).start()
    attempts = []
    try:
        engine = ServeSequentialMinimalKEngine(pad_member(graph.arrays, cls),
                                               sched)
        t = time.perf_counter()
        res = find_minimal_coloring(
            engine, initial_k=graph.initial_k(), strict_decrement=True,
            validate=make_validator(graph.arrays),
            on_attempt=lambda r, v: attempts.append(
                (int(r.k), r.status.name, int(r.supersteps))),
            post_reduce=make_reducer(graph.arrays))
        sweep_s = time.perf_counter() - t
    finally:
        sched.stop()
    graph.save_coloring(path, res.colors)
    return attempts, sweep_s, sched.stats_snapshot()


def phase_speculate_main(card: str, out_dir: Path,
                         device: str = "cuda") -> dict:
    """The strict chain of the 500k draw four ways (``SPEC_ARMS``): the
    plain ``--strict-decrement`` on ``ell-compact`` (``cli.main``), the
    serve pool's sequential arm, and ``cli.main`` with ``--speculate-k 3``
    and ``auto``. The coloring JSON and every attempt tuple equal across
    the arms; per arm the sweep's wall (``find_minimal_coloring``), the
    engine's claims, ready claims and misses, the scheduler's speculation
    counters and the launches of K13-K19 (counts zeroed just before each
    arm, read just after; the speculative arms must launch K13-K17 and
    the armed instances of K15/K16)."""
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.kernels import carry as kcar
    from dgc_tpu_torch.kernels import serve as ks

    runs = {}
    for i, (name, flags) in enumerate(SPEC_ARMS):
        d = out_dir / f"spec_arm{i}"
        d.mkdir()
        path = d / "coloring.json"
        for m in (ks, kcar):
            m.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        with _SpecProbe() as probe:
            t = time.perf_counter()
            if flags is None:
                attempts, sweep_s, stats = _serve_sequential_arm(path, 3,
                                                                 device)
                rc = 0
            else:
                rc = cli.main(SPEC_ARGS + flags + ["--device", device,
                    "--output-coloring", str(path), "--log-json",
                    str(d / "run.jsonl")])
                events = [json.loads(x) for x in
                          (d / "run.jsonl").read_text().splitlines()]
                attempts = [(e["k"], e["status"], e["supersteps"])
                            for e in events if e["event"] == "attempt"]
                check(len(probe.sweeps) == 1, f"speculation {name}: "
                      f"{len(probe.sweeps)} sweeps")
                sweep_s = probe.sweeps[0]
                stats = probe.sched[-1] if probe.sched else None
            wall = time.perf_counter() - t
        torch.cuda.synchronize()
        check(rc == 0, f"speculation {name}: rc {rc}")
        launches = {**ks.launch_counts, **kcar.launch_counts}
        spec_launches = dict(ks.spec_launch_counts)
        rec = {"phase": "speculate_main", "run": name,
               "argv": flags, "attempts": len(attempts),
               "sweep_s": sweep_s, "wall_s": wall, "launches": launches,
               "spec_launches": spec_launches,
               "engine": probe.spec[-1] if probe.spec else None,
               "scheduler": ({k_: v_ for k_, v_ in stats.items()
                              if k_.startswith(("spec_", "h2d", "d2h",
                                                "slices"))}
                             if stats else None),
               "peak_memory_bytes": torch.cuda.max_memory_allocated()
               - base_bytes, "card": card}
        if runs:
            first = next(iter(runs.values()))
            check(attempts == first["_attempts"], f"speculation {name}: "
                  f"attempts {attempts} vs {first['_attempts']}")
            check(filecmp.cmp(path, first["_path"], shallow=False),
                  f"speculation {name}: the coloring differs")
        if flags:
            check(all(launches[k_] > 0 for k_ in (
                "lane_superstep", "lane_compact", "lane_finish",
                "lane_reset", "lane_seat")) and all(
                v_ > 0 for v_ in spec_launches.values()),
                f"speculation {name}: launches {launches}, {spec_launches}")
        emit(rec)
        rec.update(_attempts=attempts, _path=path)
        runs[name] = rec
    for rec in runs.values():
        rec.pop("_attempts")
        rec.pop("_path")
    return runs


# ---- phase 3: K17-K19 and the armed K15/K16 at the serving class ------------

def _kernel_ms(fn, kname: str, reps: int = 10) -> float:
    """Device time of one launch of the kernel named ``kname``: ``reps``
    calls of ``fn`` in one ``_profiled`` window (its fill launches first:
    a bare window of a few µs launches can lose every record), the mean
    over the records kept."""
    total, n, _each = _profiled(lambda: [fn() for _ in range(reps)],
                                {"k": reps}, _DEVICE_MS_KEPT,
                                {"k": kname})["k"]
    return total / n


def measure_carry(card: str, device: str = "cuda") -> dict:
    """K17-K19 at the serving class's shapes (v32768w32, its auto ladder's
    slot-list width): K17 seating a wave of 32 lanes into a 32-lane pool,
    K18 and K19 growing a pool 8 → 32 with 8 lanes kept (the drawn-once
    batch-32 run's ramp). Each held exact against its plain version;
    ``ms`` from ``torch.profiler``, ``plain_ms`` the plain version's host
    wall on the card, ``bound_ms`` its bytes (each input read once, each
    output written once) over 3.35 TB/s, ``library_ms`` the PyTorch calls
    that do the same (``index_copy_`` on the two stacks; 20 indexed
    copies; ``torch.cat`` + ``index_select``), on CUDA events. ``ms``
    from ``_kernel_ms``."""
    from dgc_tpu_torch.kernels import carry as kcar
    from dgc_tpu_torch.layout import CARRY_LEN
    from dgc_tpu_torch.serve.batched import stage_idx_width
    from dgc_tpu_torch.serve.shape_classes import (ShapeClass,
                                                   stage_schedule_for)

    cls = ShapeClass(32768, 32)
    v, w = cls.v_pad, cls.w_pad
    a0 = stage_idx_width(stage_schedule_for(cls, "auto"))
    gen = torch.Generator(device=device)
    gen.manual_seed(47)

    def rand(shape):
        return torch.randint(0, 1 << 30, shape, generator=gen,
                             dtype=torch.int32, device=device)

    b, n = 32, 32
    stacks = [rand((b, v, w)), rand((b, v)), rand((b,)), rand((b,)),
              torch.zeros(b, dtype=torch.int32, device=device)]
    lanes = [int(x) for x in np.random.default_rng(47).permutation(b)]
    s_comb, s_degrees = rand((n, v, w)), rand((n, v))
    s_k0, s_ms = list(range(1, n + 1)), [2 * v + 4] * n
    plain = [t.clone() for t in stacks]
    kcar.lane_seat(*stacks, lanes, s_comb, s_degrees, s_k0, s_ms)
    kcar.lane_seat_reference(*plain, lanes, s_comb, s_degrees, s_k0, s_ms)
    worst = max(_diff(x, y) for x, y in zip(stacks, plain))
    idx = torch.tensor(lanes, dtype=torch.int64, device=device)
    row = (v * w + v + 3) * 4
    seat = {
        "ms": _kernel_ms(lambda: kcar.lane_seat(*stacks, lanes, s_comb,
                                                s_degrees, s_k0, s_ms),
                         "lane_seat_kernel"),
        "plain_ms": _host_ms(lambda: kcar.lane_seat_reference(
            *plain, lanes, s_comb, s_degrees, s_k0, s_ms), 3),
        "bound_ms": 2 * n * row / HBM_BYTES_PER_S * 1e3,
        "library_ms": _cuda_ms(lambda: (
            stacks[0].index_copy_(0, idx, s_comb),
            stacks[1].index_copy_(0, idx, s_degrees)), 10),
        "shape": f"{n} seats into {b} lanes of {cls.name}"}

    b_old, keep = 8, list(range(8))
    old = [rand((b_old, a0) if j == 18 else
                (b_old, v) if j in (2, 6, 10) else (b_old,))
           for j in range(CARRY_LEN)]
    got = kcar.carry_permute(old, keep, keep, b)
    worst = max([worst] + [_diff(x, y) for x, y in zip(
        got, kcar.carry_permute_reference(old, keep, keep, b))])
    carry_row = (3 * v + a0 + 16) * 4
    src_t = torch.tensor(keep, dtype=torch.int64, device=device)
    out = [torch.empty_like(t_) for t_ in got]

    def indexed():
        for o, x in zip(out, old):
            o[src_t] = x[src_t]

    permute = {
        "ms": _kernel_ms(lambda: kcar.carry_permute(old, keep, keep, b),
                         "carry_permute_kernel"),
        "plain_ms": _host_ms(lambda: kcar.carry_permute_reference(
            old, keep, keep, b), 3),
        "bound_ms": (len(keep) + b) * carry_row / HBM_BYTES_PER_S * 1e3,
        "library_ms": _cuda_ms(indexed, 10),
        "shape": f"{b_old} -> {b} lanes of {cls.name}, {len(keep)} kept"}

    small = [t[:b_old].contiguous() for t in stacks]
    dummy = rand((v, w))
    src = keep + [b_old] * (b - b_old)
    got = kcar.inputs_resize(*small[:4], src, dummy, 1, 2 * v + 4)
    worst = max([worst] + [_diff(x, y) for x, y in zip(
        got, kcar.inputs_resize_reference(*small[:4], src, dummy, 1,
                                          2 * v + 4))])
    src_l = torch.tensor(src, dtype=torch.int64, device=device)
    resize = {
        "ms": _kernel_ms(lambda: kcar.inputs_resize(
            *small[:4], src, dummy, 1, 2 * v + 4), "inputs_resize_kernel"),
        "plain_ms": _host_ms(lambda: kcar.inputs_resize_reference(
            *small[:4], src, dummy, 1, 2 * v + 4), 3),
        "bound_ms": ((b + len(keep) + 1) * (v * w + v) * 4 + 16 * b)
        / HBM_BYTES_PER_S * 1e3,
        "library_ms": _cuda_ms(lambda: (
            torch.cat([small[0], dummy[None]]).index_select(0, src_l),
            torch.cat([small[1], torch.zeros_like(small[1][:1])]
                      ).index_select(0, src_l)), 10),
        "shape": f"{b_old} -> {b} lanes of {cls.name}, {len(keep)} kept"}
    check(worst == 0, f"the carry kernels at the serving class differ from "
          f"their plain versions by {worst}")
    rec = {"phase": "carry_measure", "class": cls.name, "a0": a0,
           "max_abs_err": worst, "lane_seat": seat, "carry_permute": permute,
           "inputs_resize": resize, "card": card}
    emit(rec)
    return rec


def carry_kernels_line(serve: dict, spec: dict, carry: dict,
                       carry_err: int, serve_err: int) -> list[dict]:
    """K17-K19 on the device-carry replay's main path (continuous, batch 8;
    the drawn-once device-carry runs' launches beside), times at the
    serving class (``measure_carry``); the armed instances of K15/K16 with
    the ``--speculate-k 3`` arm's launches and the armed held sweep's
    times (``measure_serve``)."""
    main = serve["runs"]["continuous, batch 8, device carry"]
    fronts = {r: v["carry_launches"] for r, v in serve["fronts"].items()
              if "device carry" in r}
    err = max(carry_err, carry["max_abs_err"])
    replaces = {"lane_seat": "dgc_tpu/serve/batched.py:635",
                "carry_permute": "dgc_tpu/serve/batched.py:653",
                "inputs_resize": "dgc_tpu/serve/batched.py:679"}
    out = []
    for name in ("lane_seat", "carry_permute", "inputs_resize"):
        m = carry[name]
        out.append({"name": name, "route": "cuda",
                    "source": "dgc_tpu_torch/csrc/carry.cu",
                    "replaces": replaces[name],
                    "launches": main["carry_launches"][name],
                    "launches_other": {r: v[name] for r, v in fronts.items()},
                    "max_abs_err": err, "ms": m["ms"],
                    "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                    "bound_by": "bytes", "library_ms": m["library_ms"],
                    "shape": m["shape"]})
    meas = serve["measure"]
    arm = spec["speculate-k 3"]
    for name, line in (("lane_finish", "dgc_tpu/serve/batched.py:409"),
                       ("lane_reset", "dgc_tpu/serve/batched.py:498")):
        m = meas[name]
        out.append({"name": f"{name}_spec", "route": "cuda",
                    "source": "dgc_tpu_torch/csrc/serve.cu", "replaces": line,
                    "launches": arm["spec_launches"][name],
                    "max_abs_err": max(serve_err, meas["max_abs_err"]),
                    "ms": m["spec_ms"], "plain_ms": m["spec_plain_ms"],
                    "bound_ms": m["spec_bound_ms"], "bound_by": "bytes",
                    "library_ms": None, "off_ms": m["ms"]})
    return out


# ---- the sharded engines (B13a-f) --------------------------------------------

# the shard the kernels are held at: shard 3 of a 4-way mesh of the 1M
# tables, so that global ids and slice rows past 0 run on the card
HELD_SHARD = (4, 3)
# the sharded-bucketed knobs the held sweeps run: the defaults, every slice
# conditioned at its pad, and prune configs (tier 2 included) on every slice
SHARD_KNOBS = {"default": {}, "padded": dict(uncond_entries=0),
               "forced": dict(uncond_entries=0, prune_u_min=8,
                              prune_p2_min=8)}
# the two-rank run on one card: gloo, both ranks on cuda:0
SHARD_RANKS_ARGS = ["--node-count", "100000", "--max-degree", "32",
                    "--gen-method", "fast", "--seed", "0"]


class _ShardStub:
    """Shard ``rank`` of a mesh of ``size`` (``parallel.mesh.VertexMesh``'s
    surface) whose other shards hold fixed words ``rest``: the all-gather
    writes this shard's block over them, the reductions are this shard's
    own, ``fetch_global`` the whole vector. Lets one card drive shard 3 of
    4 of the 1M tables through the engines' own loop."""

    def __init__(self, size: int, rank: int, device):
        from dgc_tpu_torch.parallel.mesh import VertexMesh

        self._mesh = VertexMesh(size, rank, torch.device(device))
        self.size, self.rank, self.device = size, rank, self._mesh.device
        self.shape = self._mesh.shape
        self.rest = None

    def block(self, n: int) -> slice:
        return self._mesh.block(n)

    def all_gather(self, out, local) -> None:
        out.copy_(self.rest)
        out[self.block(out.shape[0])] = local

    def all_reduce(self, t, op: str) -> None:
        pass

    def fetch_global(self, local) -> np.ndarray:
        full = self.rest.clone()
        full[self.block(full.shape[0])] = local
        return full.cpu().numpy()


def _rest_words(rng, deg: np.ndarray, device) -> torch.Tensor:
    """The other shards' words: degree 0 confirms 0, the rest mostly
    confirmed below min(Δ, 40) + 1, 5% fresh and 5% uncolored."""
    col = rng.integers(0, np.minimum(deg, 40) + 1)
    r = rng.random(len(deg))
    words = np.where(r < 0.05, -1, np.where(r < 0.1, col * 2 + 1, col * 2))
    return torch.from_numpy(np.where(deg == 0, 0, words).astype(np.int32)
                            ).to(device)


def _clone(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(t) for t in x)
    return x.clone() if isinstance(x, torch.Tensor) else x


def _diff_any(a, b) -> int:
    if isinstance(a, (tuple, list)):
        return max((_diff_any(x, y) for x, y in zip(a, b)), default=0)
    return _diff(a, b) if isinstance(a, torch.Tensor) else 0


class _HeldShardKernels:
    """Within the block, every launch the sharded engines make through
    K20-K22, K5, K7 and K8 (and the ring engine through K23-K25) first
    runs the plain version on clones of what the kernel writes, then the
    kernel; the two must agree exactly (``err``). ``calls`` counts them by
    kernel, ``branches`` the hub branches K7 chose."""

    def __init__(self):
        self.err = 0
        self.calls = {}
        self.branches = set()

    def __enter__(self):
        from dgc_tpu_torch.kernels import compact as kc
        from dgc_tpu_torch.kernels import hub as kh
        from dgc_tpu_torch.kernels import ring as kr
        from dgc_tpu_torch.kernels import shard as ks

        self._saved = []

        def wrap(mod, name, plain, writes):
            real = getattr(mod, name)

            def held(*args, **kw):
                args = list(args)
                clones = [(_clone(a) if i in writes else a)
                          for i, a in enumerate(args)]
                kw_c = {k: (_clone(v) if k in ("umax", "traj") else v)
                        for k, v in kw.items()}
                plain(*clones, **kw_c)
                real(*args, **kw)
                self.err = max([self.err] + [
                    _diff_any(args[i], clones[i]) for i in writes
                    if i < len(args)] + [_diff_any(kw[k], kw_c[k])
                                         for k in kw_c if k in ("umax",
                                                                "traj")])
                self.calls[name] = self.calls.get(name, 0) + 1
                if name == "hub_slots":
                    self.branches.update(
                        args[2][kc.LIVE_BRANCH, : len(args[3].buckets)]
                        .tolist())

            self._saved.append((mod, name, real))
            setattr(mod, name, held)

        def k5_plain(c, s, seg, plan, desc, k, th, ms, **kw):
            kc.segmented_superstep_reference(c, s, seg, plan, k, th, ms, **kw)

        wrap(ks, "shard_superstep", ks.shard_superstep_reference, (0, 1))
        wrap(ks, "shard_finish", ks.shard_finish_reference, (0, 1, 3, 5, 10))
        wrap(ks, "shard_pair", ks.shard_pair_reference, (0, 1, 2, 6))
        wrap(kc, "segmented_superstep", k5_plain, (0, 1))
        wrap(kh, "hub_slots", kh.hub_slots_reference, (0, 1, 2, 4))
        wrap(kh, "hub_superstep", kh.hub_superstep_reference, (0, 1, 3, 5))
        wrap(kr, "ring_stats", kr.ring_stats_reference, (4,))
        wrap(kr, "ring_stats_wide", kr.ring_stats_wide_reference, (4,))
        wrap(kr, "ring_apply", kr.ring_apply_reference, (0, 2, 3))
        return self

    def __exit__(self, *exc):
        for mod, name, real in self._saved:
            setattr(mod, name, real)
        return False


def _held_sweep(engine, k0: int, record: bool) -> dict:
    """One sweep of ``engine`` (on a ``_ShardStub``) with every kernel held
    against its plain version; with ``record``, telemetry on."""
    engine.record_trajectory = record
    with _HeldShardKernels() as held:
        first, second = engine.sweep(k0)
        torch.cuda.synchronize()
    engine.record_trajectory = False
    check(held.err == 0, f"a shard kernel disagrees with its plain version "
                         f"at shard {HELD_SHARD[1]} of {HELD_SHARD[0]}: max "
                         f"abs err {held.err} ({held.calls})")
    return {"calls": held.calls, "branches": sorted(held.branches),
            "first": (first.k, int(first.status), first.supersteps),
            "second": None if second is None else (
                second.k, int(second.status), second.supersteps),
            "resumed_from_step": engine.resumed_from_step}


def _shard_edge_cases(device) -> int:
    """K21 and K22 on seeded random control blocks, carries, rings and live
    tables: failing and ending steps, pushes and no pushes, the trajectory
    row, a launch after the attempt ended; the pair in every status, with
    brackets that hold k2 in no, one or several ring slots. Returns the
    max abs error (0)."""
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.kernels import shard as ks
    from dgc_tpu_torch.obs.kernel import traj_empty

    rng = np.random.default_rng(23)
    err = 0
    for case in range(200):
        vl = int(rng.choice([1, 37, 1000, 100_000]))
        nh = int(rng.integers(0, 4))
        nb = max(nh, 1)
        live = None
        if nh:
            live = torch.from_numpy(rng.integers(
                0, 50, size=(kc.LIVE_ROWS, nb)).astype(np.int32)).to(device)
        ring = (torch.from_numpy(rng.integers(-1, 80, size=(4, vl))
                                 .astype(np.int32)).to(device),
                torch.from_numpy(rng.integers(0, 50, size=(4, nb))
                                 .astype(np.int32)).to(device),
                torch.from_numpy(rng.integers(-1, 60, size=(4, 5))
                                 .astype(np.int32)).to(device))
        packed = torch.from_numpy(rng.integers(-1, 80, size=vl)
                                  .astype(np.int32)).to(device)
        back = torch.from_numpy(rng.integers(-1, 80, size=vl)
                                .astype(np.int32)).to(device)
        c = [int(rng.choice([0, 0, 0, 1, 2, 3])), int(rng.integers(0, 100)),
             int(rng.integers(0, 500)), int(rng.integers(0, 70)), 0,
             int(rng.choice([0, 0, 3])), int(rng.choice([0, 1, 200, 600])),
             int(rng.integers(-1, 60)), int(rng.integers(-1, 9)),
             int(rng.integers(-1, 40)), 0, int(rng.integers(0, 9)),
             int(rng.integers(-1, 60)), int(rng.integers(1, 60)),
             int(rng.choice([0, 0, 1, 2])), 0, 0, 0, -1]
        ctrl = torch.tensor(c, dtype=torch.int32, device=device)
        max_steps = int(rng.choice([ks.INT32_MAX, int(rng.integers(1, 110))]))
        window = int(rng.choice([64, int(rng.integers(1, 70))]))
        gc_const = int(rng.choice([-1, 0, 1]))
        traj = None if case % 3 else traj_empty(int(rng.integers(1, 120)),
                                                device=device)
        record = bool(case % 2)
        args = [ctrl, packed, back, ring, record, live, nh, gc_const,
                max_steps, window, traj]
        plain = _clone(args)
        plain[2] = back
        ks.shard_finish(*args)
        ks.shard_finish_reference(*plain)
        err = max(err, _diff_any([ctrl, packed, ring, live, traj],
                                 [plain[0], plain[1], plain[3], plain[5],
                                  plain[10]]))
        # the pair step, from the same inputs
        ctrl = torch.tensor(c, dtype=torch.int32, device=device)
        p1 = torch.zeros_like(packed)
        deg = torch.from_numpy(rng.integers(0, 3, size=vl).astype(np.int32)
                               ).to(device)
        init_ba = None if live is None else torch.from_numpy(
            rng.integers(0, 50, size=nb).astype(np.int32)).to(device)
        args = [ctrl, packed, p1, deg, int(rng.choice([-1, 1])), ring, live,
                nh, init_ba, int(rng.integers(0, 2)), int(rng.integers(1, 999)),
                gc_const]
        plain = _clone(args)
        ks.shard_pair(*args)
        ks.shard_pair_reference(*plain)
        err = max(err, _diff_any([ctrl, packed, p1, live],
                                 [plain[0], plain[1], plain[2], plain[6]]))
    torch.cuda.synchronize()
    check(err == 0, f"K21/K22 disagree with their plain versions on random "
                    f"inputs: max abs err {err}")
    return err


# K20's team cases: (width, rows of the shard), a group of 1, 2, 4, 8, 16
# and 32 lanes a row, the widest at max_ell_width
K20_WIDTHS = ((1, 700), (32, 600), (33, 500), (64, 400), (100, 300),
              (256, 200), (513, 100), (1024, 64), (2048, 40))


def _k20_team_cases(device) -> int:
    """K20 against its plain version at shard 3 of 4 of a 4 V_l-vertex
    state, on ragged tables of ``K20_WIDTHS`` (plain ids, real lengths
    from none to the whole width, the sentinel V past them), degrees with
    many ties, words uncolored, fresh and confirmed (colors mostly low,
    some past the window), at 1, 2 and 3 planes with budgets inside and
    past the window, both fail gates. Returns the max abs error."""
    from dgc_tpu_torch.kernels import shard as ks
    from dgc_tpu_torch.kernels.superstep import real_lengths

    rng = np.random.default_rng(20)
    size, rank = HELD_SHARD
    err = 0
    for width, vl in K20_WIDTHS:
        v = size * vl
        row_off = rank * vl
        real = rng.integers(0, width + 1, vl)
        table = np.where(np.arange(width) < real[:, None],
                         rng.integers(0, v, (vl, width)), v)
        nbrs = torch.from_numpy(table.astype(np.int32)).to(device)
        lens = real_lengths(nbrs, v)
        deg = torch.from_numpy(np.concatenate(
            [rng.integers(0, 5, v), [-1]]).astype(np.int32)).to(device)
        cols = np.where(rng.random(v) < 0.8, rng.integers(0, 6, v),
                        rng.integers(0, 140, v))
        kind = rng.random(v)
        words = np.where(kind < 0.2, -1, np.where(kind < 0.7, cols * 2 + 1,
                                                  cols * 2))
        state = ks.new_shard_state(v, device)
        state[0, :v] = torch.from_numpy(words.astype(np.int32)).to(device)
        for planes in (1, 2, 3):
            for k in (1, 6, 33, 32 * planes, 32 * planes + 7):
                for fv in (False, True):
                    ctrl = ks.new_shard_ctrl(3, v, k, -1, device)
                    s_k, c_k = state.clone(), ctrl.clone()
                    s_p, c_p = state.clone(), ctrl.clone()
                    ks.shard_superstep(c_k, s_k, nbrs, lens, deg, row_off,
                                       planes, k, fv)
                    ks.shard_superstep_reference(c_p, s_p, nbrs, lens, deg,
                                                 row_off, planes, k, fv)
                    err = max(err, _diff(s_k, s_p), _diff(c_k, c_p))
    torch.cuda.synchronize()
    return err


def phase_shard_kernels(device, graphs: dict) -> dict:
    """K20-K22 and the sharded-bucketed engine's K5, K7 and K8 held against
    their plain versions: one sweep of each engine as shard 3 of 4 of the
    1M tables (``_ShardStub``: the other shards' words fixed), the flat
    engine on the uniform draw, the bucketed one on the uniform draw at
    its defaults and on the RMAT draw at each of ``SHARD_KNOBS`` (the RMAT
    forced knobs with telemetry on: K21's recording variant); then
    ``_shard_edge_cases``. Returns the calls by kernel and the RMAT
    branches."""
    from dgc_tpu_torch.engine.sharded import ShardedELLEngine
    from dgc_tpu_torch.engine.sharded_bucketed import ShardedBucketedEngine
    from dgc_tpu_torch.engine.hub import BRANCH_NAMES

    rng = np.random.default_rng(7)
    size, rank = HELD_SHARD
    runs = []
    cases = [("sharded", "fast", {}), ("sharded-bucketed", "fast", {})] + [
        ("sharded-bucketed", "rmat", kw) for kw in SHARD_KNOBS.values()]
    for backend, gen, kw in cases:
        mesh = _ShardStub(size, rank, device)
        arrays = graphs[gen]
        if backend == "sharded":
            engine = ShardedELLEngine(arrays, mesh=mesh, device=device)
            deg = engine.deg_g[:-1].cpu().numpy()
        else:
            engine = ShardedBucketedEngine(arrays, mesh=mesh, device=device,
                                           **kw)
            deg = np.asarray(engine.layout.deg_final)
        mesh.rest = _rest_words(rng, deg, device)
        record = gen == "rmat" and kw is SHARD_KNOBS["forced"]
        k0 = int(arrays.max_degree) + 1
        rec = _held_sweep(engine, k0, record)
        rec.update(backend=backend, gen=gen, knobs=kw, telemetry=record,
                   hub_buckets=len(getattr(engine, "cond_idx", ())))
        runs.append(rec)
        del engine
    need = {"sharded": ("shard_superstep", "shard_finish", "shard_pair")}
    for r in runs:
        names = need.get(r["backend"], ("shard_finish", "shard_pair"))
        check(all(r["calls"].get(n, 0) > 0 for n in names),
              f"{r['backend']} {r['gen']}: held calls {r['calls']}")
    taken = {BRANCH_NAMES[b] for r in runs if r["gen"] == "rmat"
             for b in r["branches"]}
    check(taken == set(BRANCH_NAMES), f"the RMAT shard took {taken}")
    check(any(r["calls"].get("segmented_superstep") for r in runs)
          and any(r["calls"].get("hub_superstep") for r in runs),
          "no held sweep ran K5 and K8")
    err = _shard_edge_cases(device)
    teams = _k20_team_cases(device)
    check(teams == 0, f"K20's team cases differ from its plain version by "
                      f"{teams}")
    return {"runs": runs, "branches": sorted(taken), "max_abs_err": err}



def _shard_timing(engine, k: int) -> dict:
    """K20 (the flat engine), K21 and K22 timed on this rank at the
    engine's shapes (world size 1): the first superstep's gathered state;
    K21 folding that superstep with a ring push, without and with the
    trajectory row; K22 at the end of phase 0 resuming from a ring entry;
    and the collectives of one superstep. Beside each, its plain version's
    time and its bound (bytes over the H100's 3.35 TB/s)."""
    from dgc_tpu_torch.engine.fused import shard_rec_empty
    from dgc_tpu_torch.kernels import shard as ks
    from dgc_tpu_torch.obs.kernel import traj_cap_for, traj_empty

    mesh, dev = engine.mesh, engine.packed_l.device
    vl = engine.packed_l.shape[0]
    v = engine.state.shape[1] - 2
    gathered = engine.state[0, :v]
    ctrl0 = engine._start(k)
    mesh.all_gather(gathered, engine.packed_l)
    ctrl = ctrl0.clone()

    def collectives():
        mesh.all_gather(gathered, engine.packed_l)
        mesh.all_reduce(ctrl[ks.SUM_SLOTS], "sum")
        mesh.all_reduce(ctrl[ks.MAX_SLOTS], "max")

    out = {"collectives_ms": _cuda_ms(collectives, reps=50),
           "collectives_host_ms": _host_ms(collectives, reps=50),
           "collective_bytes": 4 * v + 4 * 5}
    live0 = None if engine.live is None else engine.live.clone()

    def reset(c):
        ctrl.copy_(c)
        if live0 is not None:
            engine.live.copy_(live0)

    if hasattr(engine, "nbrs"):
        window = 32 * engine.num_planes
        fv = window >= engine.max_degree + 1 or k <= window

        def k20(fn=ks.shard_superstep):
            reset(ctrl0)
            fn(ctrl, engine.state, engine.nbrs, engine.lens, engine.deg_g,
               engine.row_off, engine.num_planes, k, fv)

        out["k20_ms"] = _device_ms(k20, 20, "shard_superstep_kernel")
        out["k20_plain_ms"] = _host_ms(
            lambda: k20(ks.shard_superstep_reference), reps=3)
        # the rule needs the shard's real neighbour entries (the table's
        # padding is not work, as for K1), the gathered state and degrees
        # read, the shard's words written; the padded table's bytes are
        # kept beside it
        real = int((engine.nbrs != v).sum())
        k20_bytes = real * 4 + 2 * v * 4 + vl * 4
        out.update(k20_bytes=k20_bytes, k20_real_entries=real,
                   k20_table_bytes=engine.nbrs.numel() * 4,
                   k20_bound_ms=k20_bytes / HBM_BYTES_PER_S * 1e3)
    # K21 folding the first superstep, its words pushed into the ring
    reset(ctrl0)
    engine._superstep(ctrl, k)
    step1 = ctrl.clone()
    nb = 1 if engine.live is None else engine.live.shape[1]
    ring = shard_rec_empty(vl, nb, dev)
    packed0 = engine.packed_l.clone()
    traj = traj_empty(traj_cap_for(engine.max_steps), device=dev)
    check(int(step1[ks.CTRL_FAIL]) == 0 and int(step1[ks.CTRL_MC]) >= 0,
          f"the first superstep does not push: {step1.tolist()}")

    def k21(fn=ks.shard_finish, rec=None):
        reset(step1)
        engine.packed_l.copy_(packed0)
        fn(ctrl, engine.packed_l, engine.back, ring, True, engine.live,
           engine.nh, engine.gc_const, engine.max_steps, 64, rec)

    out["k21_ms"] = _device_ms(k21, 20, "shard_finish_kernel")
    out["k21_plain_ms"] = _host_ms(lambda: k21(ks.shard_finish_reference),
                                   reps=5)
    out["k21_rec_ms"] = _device_ms(lambda: k21(rec=traj), 20,
                                   "shard_finish_kernel")
    out["k21_rec_plain_ms"] = _host_ms(
        lambda: k21(ks.shard_finish_reference, traj), reps=5)
    # the carry and the back rows read, the carry and the ring slot written
    k21_bytes = 4 * vl * 4
    out.update(k21_bytes=k21_bytes,
               k21_bound_ms=k21_bytes / HBM_BYTES_PER_S * 1e3,
               k21_rec_bound_ms=(k21_bytes + 6 * 4) / HBM_BYTES_PER_S * 1e3)
    # K22 at phase 0's end: SUCCESS with 21 colors, slot 0 brackets k2
    end = ctrl0.clone()
    end[ks.CTRL_STATUS] = 1
    end[ks.SC_MAXC] = 20
    end[ks.SC_REC_CNT] = 1
    ring[2][0] = torch.tensor([3, -1, 1 << 30, 0, v], dtype=torch.int32)
    p1 = torch.empty_like(engine.packed_l)

    def k22(fn=ks.shard_pair):
        reset(end)
        engine.packed_l.copy_(packed0)
        fn(ctrl, engine.packed_l, p1, engine.deg_l, engine.init_word, ring,
           engine.live, engine.nh, engine.init_ba, engine.init_step,
           engine.init_prev, engine.gc_const)

    out["k22_ms"] = _device_ms(k22, 20, "shard_pair_kernel")
    out["k22_plain_ms"] = _host_ms(lambda: k22(ks.shard_pair_reference),
                                   reps=5)
    # the carry and the ring slot read, the result slot and carry written
    k22_bytes = 4 * vl * 4
    out.update(k22_bytes=k22_bytes,
               k22_bound_ms=k22_bytes / HBM_BYTES_PER_S * 1e3)
    return out


def _shard_kernels(*mods) -> dict:
    return {n: c for m in mods for counts in (m.launch_counts,
                                             m.rec_launch_counts)
            for n, c in counts.items()}


# the two ranks on one card: the CLI as torchrun starts it; the group
# picks gloo by itself, since the ranks outnumber the cards (NCCL refuses
# two ranks on one device), and the script prints which backend it got
_RANK_SCRIPT = """
import sys
import torch.distributed as dist
from dgc_tpu_torch import cli
for backend in ("sharded", "sharded-bucketed"):
    rc = cli.main(sys.argv[2:] + ["--backend", backend, "--output-coloring",
                                  f"{sys.argv[1]}/{backend}.json"])
    if rc != 0:
        raise SystemExit(rc)
print("group backend:", dist.get_backend())
"""


def _shard_ranks_run(out_dir: Path) -> dict:
    """``SHARD_RANKS_ARGS`` through the CLI at two gloo ranks, both on
    cuda:0 (children started as ``torchrun`` starts them), each backend's
    coloring JSON equal, rank by rank, to the world-size-1 run's under
    NCCL (in this process, while the children run)."""
    import os
    import socket

    from dgc_tpu_torch import cli

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    t = time.perf_counter()
    for rank in range(2):
        d = out_dir / f"ranks-{rank}"
        d.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   LOCAL_WORLD_SIZE="2", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_SCRIPT, str(d), *SHARD_RANKS_ARGS],
            cwd=Path(__file__).resolve().parent, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    one = out_dir / "ranks-world1"
    one.mkdir(parents=True, exist_ok=True)
    for backend in ("sharded", "sharded-bucketed"):
        check(cli.main(SHARD_RANKS_ARGS + [
            "--backend", backend, "--output-coloring",
            str(one / f"{backend}.json")]) == 0, f"{backend}: world size 1")
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise SmokeFailure("the two-rank run did not end in 600 s")
        outs.append((p.returncode, so, se))
    wall = time.perf_counter() - t
    for rank, (rc, so, se) in enumerate(outs):
        check(rc == 0, f"rank {rank} of the gloo run exited {rc}: "
                       f"{se.strip().splitlines()[-3:]}")
        check("group backend: gloo" in so.splitlines(),
              f"rank {rank} did not run on gloo: {so.splitlines()[-1:]}")
        for backend in ("sharded", "sharded-bucketed"):
            check(filecmp.cmp(out_dir / f"ranks-{rank}" / f"{backend}.json",
                              one / f"{backend}.json", shallow=False),
                  f"rank {rank}'s {backend} coloring differs from the "
                  f"world-size-1 run's")
    return {"phase": "sharded_two_ranks", "graph": " ".join(SHARD_RANKS_ARGS),
            "backend": "gloo on cuda:0", "wall_s": wall,
            "attempt_lines": [line for line in outs[0][1].splitlines()
                              if line.startswith("attempt:")]}


def phase_sharded_main(card: str, out_dir: Path, main_runs: dict,
                       rmat_runs: dict) -> dict:
    """The sharded engines through the CLI's calls at world size 1 under
    NCCL: ``sharded`` and ``sharded-bucketed`` on the 1M uniform draw,
    ``sharded-bucketed`` on the 1M RMAT draw. The launch counts are zeroed
    just before each sweep and read just after, and each must launch every
    kernel of its path; the coloring JSON must be byte for byte the
    ``ell`` (``ell-bucketed``) run's on the same draw, and so must the
    attempts. Then each engine's kernels timed (``_shard_timing``), the
    held sweeps at shard 3 of 4 (``phase_shard_kernels``), a telemetry run
    (``--run-manifest``: K21's recording variant) and the two-rank gloo run
    (``_shard_ranks_run``)."""
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.kernels import compact as kc
    from dgc_tpu_torch.kernels import hub as kh
    from dgc_tpu_torch.kernels import shard as ks

    runs, graphs, loaded = {}, {}, {}
    for argv, backends, refs in ((MAIN_ARGS, ("sharded", "sharded-bucketed"),
                                  main_runs),
                                 (RMAT_ARGS, ("sharded-bucketed",),
                                  rmat_runs)):
        args = cli.build_parser().parse_args(
            argv + ["--output-coloring", str(out_dir / "coloring.json")])
        t = time.perf_counter()
        graph = cli.load_graph(args)
        gen_s = time.perf_counter() - t
        check(graph_sha256(graph.arrays) == DRAW_SHA256[args.gen_method],
              f"the {args.gen_method} draw is not the pinned one")
        graphs[args.gen_method] = graph.arrays
        loaded[args.gen_method] = graph
        for backend in backends:
            args.backend = backend
            t = time.perf_counter()
            engine = cli.make_engine(args, graph)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t
            torch.cuda.reset_peak_memory_stats()
            for mod in (ks, kc, kh):
                mod.reset_launch_counts()
            timed = _TimedSweepEngine(engine)
            result = cli.sweep(args, graph, timed)
            torch.cuda.synchronize()
            launches = _shard_kernels(ks, kc, kh)
            ref_name = "ell" if backend == "sharded" else "ell-bucketed"
            ref = refs[ref_name]
            path = out_dir / f"coloring-{args.gen_method}-{backend}.json"
            graph.save_coloring(str(path), result.colors)
            check(filecmp.cmp(path, out_dir / f"coloring-{args.gen_method}-"
                                              f"{ref_name}.json",
                              shallow=False),
                  f"{backend} on {args.gen_method}: the coloring JSON "
                  f"differs from {ref_name}'s")
            attempts = [[a.k, a.status.name, a.supersteps, a.colors_used]
                        for a in result.attempts]
            check(attempts == [list(a) for a in ref["attempts"]],
                  f"{backend}: attempts {attempts}, {ref_name} "
                  f"{ref['attempts']}")
            need = ["shard_finish", "shard_pair"] + (
                ["shard_superstep"] if backend == "sharded" else
                (["segmented_superstep"] if engine.uncond_idx else [])
                + (["hub_slots", "hub_superstep"] if engine.cond_idx
                   else []))
            check(all(launches[n] > 0 for n in need),
                  f"{backend}: the sweep skipped a kernel of its path: "
                  f"{launches}")
            rec = {"phase": "sharded_main", "backend": backend,
                   "graph": " ".join(argv), "gen_s": gen_s,
                   "engine_build_s": build_s,
                   "sweep_s": result.wall_time_s - result.post_reduce_s,
                   "attempt_s": timed.seconds,
                   "supersteps": result.total_supersteps,
                   "attempts": attempts, "launches": launches,
                   "colors_after_post_pass": result.minimal_colors,
                   "ell_sweep_s": ref["sweep_s"],
                   "confirm_resumed_from_step": engine.resumed_from_step,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "card": card}
            if backend == "sharded-bucketed":
                rec.update(
                    uncond_slices=len(engine.uncond_idx),
                    conditioned_slices=len(engine.cond_idx),
                    pads=list(engine.pads),
                    prune_cfg=[None if c is None else list(c)
                               for c in engine.prune_cfg])
            rec.update(_shard_timing(engine, graph.initial_k()))
            emit(rec)
            runs[f"{backend} {args.gen_method}"] = rec
            del engine, timed
    t = time.perf_counter()
    held = phase_shard_kernels("cuda", graphs)
    emit({"phase": "shard_kernels_vs_plain", **held,
          "seconds": time.perf_counter() - t})
    # telemetry on: K21's recording variant, the coloring unchanged
    d = out_dir / "sharded-telemetry"
    d.mkdir(parents=True, exist_ok=True)
    for mod in (ks, kc, kh):
        mod.reset_launch_counts()
    rc = cli.main(MAIN_ARGS + ["--backend", "sharded-bucketed",
                               "--output-coloring", str(d / "colors.json"),
                               "--log-json", str(d / "run.jsonl"),
                               "--run-manifest", str(d / "manifest.json"),
                               "--metrics-prom", str(d / "metrics.prom")])
    torch.cuda.synchronize()
    tel = _shard_kernels(ks, kc, kh)
    check(rc == 0 and tel["shard_finish_rec"] > 0
          and tel["shard_finish"] == 0, f"telemetry run: rc {rc}, {tel}")
    check(filecmp.cmp(d / "colors.json",
                      out_dir / "coloring-fast-sharded-bucketed.json",
                      shallow=False), "telemetry on changed the coloring")
    files = _check_telemetry_files("sharded-bucketed", d, False)
    ranks = _shard_ranks_run(out_dir)
    emit(ranks)
    return {"runs": runs, "held": held, "telemetry_launches": tel,
            "telemetry": files, "ranks": ranks, "graphs": loaded}


def shard_kernels_line(sharded: dict) -> list[dict]:
    """K20-K22 (and K21's recording variant): launches on the 1M uniform
    ``sharded`` sweep (the ``sharded-bucketed`` sweeps' beside), time,
    plain time and bound at that path's shapes."""
    flat = sharded["runs"]["sharded fast"]
    src = "dgc_tpu_torch/csrc/shard.cu"
    err = sharded["held"]["max_abs_err"]

    def others(name):
        return {k: r["launches"][name] for k, r in sharded["runs"].items()
                if k != "sharded fast"}

    def entry(name, key, replaces, launches=None, bound_key=None):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": (flat["launches"][name] if launches is None
                             else launches),
                "launches_other": others(name), "max_abs_err": err,
                "ms": flat[f"{key}_ms"], "plain_ms": flat[f"{key}_plain_ms"],
                "bound_ms": flat[bound_key or f"{key}_bound_ms"],
                "bound_by": "bytes", "library_ms": None}

    return [entry("shard_superstep", "k20", "dgc_tpu/engine/sharded.py:64"),
            entry("shard_finish", "k21", "dgc_tpu/engine/fused.py:127"),
            entry("shard_pair", "k22", "dgc_tpu/engine/fused.py:157"),
            entry("shard_finish_rec", "k21_rec", "dgc_tpu/obs/kernel.py:95",
                  launches=sharded["telemetry_launches"]["shard_finish_rec"])]


# ---- the ring-halo engine (B13g: K23-K25) -----------------------------------

# the three-rank run on one card: gloo, every rank on cuda:0, both the
# all-gather and the ring engine (argv: the output directory, V, the CLI's
# arguments)
RING_RANKS = 3
_RING_RANK_SCRIPT = """
import json, sys, time
import torch
import torch.distributed as dist
from dgc_tpu_torch import cli
from dgc_tpu_torch.parallel.mesh import make_mesh
mem = {}
for backend in ("sharded", "sharded-ring"):
    torch.cuda.reset_peak_memory_stats()
    rc = cli.main(sys.argv[3:] + ["--backend", backend, "--output-coloring",
                                  f"{sys.argv[1]}/{backend}.json"])
    if rc != 0:
        raise SystemExit(rc)
    mem[backend] = torch.cuda.max_memory_allocated()
# one rotation of a rank's block of the same graph, timed on the host
mesh = make_mesh()
vl = -(-int(sys.argv[2]) // mesh.size)
a = torch.zeros(vl, dtype=torch.int32, device=mesh.device)
b = torch.empty_like(a)
mesh.rotate(b, a)
torch.cuda.synchronize()
t = time.perf_counter()
for _ in range(20):
    mesh.rotate(b, a)
torch.cuda.synchronize()
print(json.dumps({"backend": dist.get_backend(), "staged": mesh.staged,
                  "max_memory_allocated": mem,
                  "rotate_ms": (time.perf_counter() - t) * 1e3 / 20}))
"""


class _RingStub(_ShardStub):
    """Shard ``rank`` of a ring of ``size`` whose other shards hold fixed
    words ``rest`` (global, int32[V]): the k-th rotation of a superstep
    receives shard ``(rank − k) mod size``'s block, the reductions are
    this shard's own. Lets one card drive shard 3 of 4 of the 1M rotation
    tables through the ring engine's own superstep."""

    def __init__(self, size: int, rank: int, device):
        super().__init__(size, rank, device)
        self._rot = 0

    def rotate(self, dst, src) -> None:
        self._rot = self._rot % (self.size - 1) + 1
        o = (self.rank - self._rot) % self.size
        vl = dst.shape[0]
        dst.copy_(self.rest[o * vl: (o + 1) * vl])


def _ring_bytes(engine, ctrl, block, launches, planes: int, *,
                one_launch: bool = False) -> int:
    """The bytes K23/K24 must move over ``launches`` (``(rows, table, ...)``
    tuples: the buckets of K23's ``NarrowTables`` or of K24's
    ``WideTables``, all in one launch with ``one_launch``, else a launch a
    table) on this state: a row list's entries, the packed word of each
    real row; for each row that is not confirmed, its real entries, the
    block words they name (at most one a real entry, at most the block,
    once a launch), its length where the layout has one (K23's), and the
    accumulator words its stats make nonzero and its mask, read and
    written (the clash flag written only where set): counted from each
    table's own stats, by ``table_stats`` into zeroed accumulators."""
    from dgc_tpu_torch.kernels import ring as kr

    vl = engine.packed_l.shape[0]
    own = kr.new_acc(planes, vl, block.device)
    total = 0
    reals = []
    for rows, table, *lens in launches:
        local = (torch.arange(table.shape[0], device=block.device)
                 if rows is None else rows.long())
        real_row = local < vl
        word = engine.packed_l[torch.where(real_row, local, 0)]
        live = real_row & ~((word >= 0) & (word & 1 == 0))
        real = int((((table & ((1 << 30) - 1)) != vl) & live[:, None]).sum())
        reals.append(real)
        own.zero_()
        kr.table_stats(block, engine.packed_l, table, rows, own, planes)
        words = int((own[: 2 * planes] != 0).sum())
        clash = int(own[2 * planes].sum())
        masks = int((own[2 * planes + 1] != 0).sum())
        total += (4 * real + 4 * int(real_row.sum()) + 8 * words + 4 * clash
                  + 8 * masks + (0 if rows is None else 4 * table.shape[0])
                  + (4 * int(live.sum()) if lens else 0))
    gathers = [sum(reals)] if one_launch else reals
    return total + sum(4 * min(g, vl + 1) for g in gathers)


def _k25_bytes(acc: torch.Tensor, planes: int) -> dict:
    """What K25 must move from accumulators ``acc``: each row's word, mask
    and clash flag read and its new word written (16 bytes a row), the
    words of the planes its mask names read and the nonzero ones zeroed,
    the nonzero masks and set clash flags zeroed; beside it the dense
    figure, every row's word, 2P + 1 accumulators and new word."""
    from dgc_tpu_torch.kernels import ring as kr

    vl = acc.shape[1]
    group = torch.arange(planes, device=acc.device) // kr.mask_group(planes)
    mask = acc[2 * planes + 1].to(torch.int64) & 0xFFFFFFFF
    touched = ((mask[None, :] >> group[:, None]) & 1) == 1
    both = torch.cat([touched, touched])
    words = int(both.sum())
    nonzero = int((both & (acc[: 2 * planes] != 0)).sum())
    return {"k25_bytes": 16 * vl + 4 * words + 4 * nonzero
            + 4 * int((mask != 0).sum())
            + 4 * int((acc[2 * planes] != 0).sum()),
            "k25_touched_words": words,
            "k25_rows_touched": int((mask != 0).sum()),
            "k25_dense_bytes": 4 * vl * (2 + 2 * planes + 1)}


def _ring_held_steps(engine, k: int, planes: int, words: np.ndarray,
                     steps: int = 2) -> dict:
    """``steps`` supersteps of ``engine`` (on a ``_RingStub`` or its own
    mesh) from the ``words`` at a window of ``planes`` planes and budget ``k``,
    every K23, K24, K25 and K21 launch held against its plain version."""
    from dgc_tpu_torch.engine.fused import shard_superstep_epilogue
    from dgc_tpu_torch.kernels import shard as ks

    engine.num_planes = planes
    ctrl = engine._start(k)
    engine.packed_l.copy_(torch.from_numpy(words).to(engine.packed_l.device))
    with _HeldShardKernels() as held:
        for _ in range(steps):
            engine._superstep(ctrl, k)
            shard_superstep_epilogue(engine, ctrl, None)
        torch.cuda.synchronize()
    check(held.err == 0, f"a ring kernel disagrees with its plain version "
                         f"at shard {engine.mesh.rank} of {engine.mesh.size}"
                         f", {planes} planes, k={k}: max abs err {held.err} "
                         f"({held.calls})")
    check(int(ctrl[ks.CTRL_STEP]) > 0, f"no superstep ran: {ctrl.tolist()}")
    return {"planes": planes, "k": k, "calls": held.calls,
            "ctrl": ctrl.tolist()[:8]}


def _ring_tables(rng, vl: int, flat: bool, widths) -> list:
    """A rotation's tables over ``vl`` local rows: one flat table of the
    first width (every row, a row list of None), or a bucket a width over
    disjoint random rows, each with its padding rows (the sentinel
    ``vl``) in random places; every table row of a random real length,
    the sentinel past it."""
    if flat:
        groups = [None]
    else:
        widths = widths[: max(1, min(len(widths), vl))]
        cuts = np.sort(rng.choice(np.arange(1, vl), len(widths) - 1,
                                  replace=False)) if len(widths) > 1 else []
        groups = [np.concatenate([g, np.full(int(rng.integers(0, 4)), vl)])
                  for g in np.split(rng.permutation(vl), cuts)]
        groups = [rng.permutation(g).astype(np.int32) for g in groups]
    out = []
    for rows, width in zip(groups, widths):
        n = vl if rows is None else len(rows)
        out.append((rows, _ragged(rng, n, width, vl)))
    return out


def _ring_edge_cases(device) -> int:
    """K23, K24 and K25 on seeded random blocks, tables and accumulators
    that already hold bits: K23 over a flat table or one to three buckets
    of widths 1 to 1,500 (every team size) with padding rows, rows of
    every real length, sentinel entries, 1 to 40 planes, budgets from 1
    past the window, fresh, confirmed and uncolored words, gated and
    counted fail, a launch after the attempt ended; K24 over its work list
    at chunks of 1, 64 and the default (a 1,500-entry row over many
    blocks), held against its plain version; K25 on masks of no plane, one
    and many (random words in the planes they do not name). Then K23
    ``REPLAYS`` times on one input, each launch's bytes the plain
    version's, and once on a 65,536-wide row of 40,000 real entries.
    Returns the max abs error (0)."""
    from dgc_tpu_torch.kernels import ring as kr
    from dgc_tpu_torch.kernels import shard as ks

    rng = np.random.default_rng(31)
    err = 0

    def t(x):
        return torch.from_numpy(np.asarray(x, np.int32)).to(device)

    def random_acc(vl, planes):
        acc = rng.integers(-(1 << 31), 1 << 31, size=(2 * planes + 2, vl))
        acc[2 * planes] = rng.integers(0, 2, size=vl)
        # masks of no plane, of plane 0 alone, of random planes
        acc[2 * planes + 1] = np.choose(rng.integers(0, 3, size=vl),
                                        [np.zeros(vl, np.int64),
                                         np.ones(vl, np.int64),
                                         acc[2 * planes + 1]])
        return acc

    for case in range(120):
        vl = int(rng.choice([1, 5, 300, 4000]))
        planes = int(rng.choice([1, 2, 3, 5, 17, 32, 33, 40]))
        k = int(rng.choice([1, 7, 31, 32, 33, 32 * planes, 32 * planes + 9]))
        max_color = int(rng.choice([4, 40, 32 * planes + 40]))
        block = _packed_words(rng, vl + 1, max_color, 0.5)
        block[vl] = -1
        packed = _packed_words(rng, vl, max_color, 0.5)
        widths = [int(w) for w in rng.choice(
            [1, 3, 4, 32, 33, 64, 256, 300, 1500], size=3)]
        tables = _ring_tables(rng, vl, bool(case % 2),
                              widths[: int(rng.integers(1, 4))])
        acc = random_acc(vl, planes)
        c = [int(rng.choice([0, 0, 0, 1])), 3, 900, 2, 0,
             int(rng.integers(0, 5)), int(rng.integers(0, 50)),
             int(rng.integers(-1, 60))]
        ctrl = torch.tensor(c + [-1] * (ks.SC_LEN - 8), dtype=torch.int32,
                            device=device)
        blk, pk = t(block), t(packed)
        narrow = kr.NarrowTables(tables, vl, device)
        a1, a2 = t(acc), t(acc)
        kr.ring_stats(ctrl, blk, pk, narrow, a1, planes)
        kr.ring_stats_reference(ctrl, blk, pk, narrow, a2, planes)
        err = max(err, _diff(a1, a2))
        rows, table = tables[0]
        chunks = ([1, 64, kr.WIDE_CHUNK] if table.shape[1] <= 32
                  else [64, kr.WIDE_CHUNK])
        wide = kr.WideTables([(rows, table)], vl, device,
                             int(rng.choice(chunks)))
        a3, a4 = t(acc), t(acc)
        kr.ring_stats_wide(ctrl, blk, pk, wide, a3, planes)
        kr.ring_stats_wide_reference(ctrl, blk, pk, wide, a4, planes)
        err = max(err, _diff(a3, a4))
        back = t(rng.integers(-1, 80, size=vl))
        fv = bool(rng.integers(0, 2))
        args = [ctrl, pk, a1, back, planes, k, fv]
        plain = _clone(args)
        kr.ring_apply(*args)
        kr.ring_apply_reference(*plain)
        err = max(err, _diff_any([ctrl, a1, back],
                                 [plain[0], plain[2], plain[3]]))
    # K23's team ORs on one input, REPLAYS times
    vl, planes = 4000, 32
    block = _packed_words(rng, vl + 1, 200, 0.5)
    block[vl] = -1
    blk, pk = t(block), t(_packed_words(rng, vl, 200, 0.7))
    narrow = kr.NarrowTables(_ring_tables(rng, vl, False, [4, 32, 256]), vl,
                             device)
    ctrl = ks.new_shard_ctrl(0, vl + 1, 100, -1, device)
    acc = t(random_acc(vl, planes))
    plain = acc.clone()
    kr.ring_stats_reference(ctrl, blk, pk, narrow, plain, planes)
    for _ in range(REPLAYS):
        again = acc.clone()
        kr.ring_stats(ctrl, blk, pk, narrow, again, planes)
        err = max(err, _diff(again, plain))
    # a 65,536-wide row of 40,000 real entries (a warp's lanes), beside a
    # bucket of 4-wide rows
    narrow = kr.NarrowTables(
        [(np.array([0], np.int32), _ragged(rng, 1, 65536, vl, [40_000])),
         (np.arange(1, vl, dtype=np.int32), _ragged(rng, vl - 1, 4, vl))],
        vl, device)
    a1 = t(random_acc(vl, planes))
    a2 = a1.clone()
    kr.ring_stats(ctrl, blk, pk, narrow, a1, planes)
    kr.ring_stats_reference(ctrl, blk, pk, narrow, a2, planes)
    err = max(err, _diff(a1, a2))
    torch.cuda.synchronize()
    check(err == 0, f"K23-K25 disagree with their plain versions on random "
                    f"inputs: max abs err {err}")
    return err


def _ring_world1_held(engine, k: int, bucketed: bool) -> dict:
    """Two supersteps of the main path's own engine (world size 1: one
    rotation over the whole flat table, or every RMAT bucket with K24 on
    the hub rows) with every K23, K24, K25 and K21 launch held against its
    plain version: from the carry ``_ring_timing`` left, and from seeded
    words with colors over the whole window."""
    rng = np.random.default_rng(23)
    planes = engine.num_planes
    vl = engine.packed_l.shape[0]
    words = {"carry": engine.packed_l.cpu().numpy(),
             "seeded": _packed_words(rng, vl, min(engine.max_degree,
                                                  32 * planes) + 1, 0.3)}
    steps = {name: _ring_held_steps(engine, k, planes, w)
             for name, w in words.items()}
    need = ["ring_stats", "ring_apply", "shard_finish"] + (
        ["ring_stats_wide"] if bucketed else [])
    for name, st in steps.items():
        check(all(st["calls"].get(n, 0) > 0 for n in need),
              f"world size 1, {name} words: held calls {st['calls']}")
    return steps


def phase_ring_kernels(device, graphs: dict) -> dict:
    """K23, K24 and K25 held against their plain versions as shard 3 of 4
    of the 1M rotation tables (``_RingStub``: the other shards' words
    fixed): the flat layout of the uniform draw and the bucketed layout of
    the RMAT draw (K24 over every bucket wider than ``WIDE_WIDTH``, one
    launch a rotation, in every rotation), two supersteps from seeded
    words at a one-plane window and at the engine's, each at the main
    path's budget and at 12; then ``_ring_edge_cases``. Returns the calls
    by kernel."""
    from dgc_tpu_torch.engine.ring import RingHaloEngine
    from dgc_tpu_torch.kernels import ring as kr

    rng = np.random.default_rng(19)
    size, rank = HELD_SHARD
    runs = []
    for gen, bucketed in (("fast", False), ("rmat", True)):
        mesh = _RingStub(size, rank, device)
        arrays = graphs[gen]
        engine = RingHaloEngine(arrays, mesh=mesh, device=device)
        check(engine.bucket_tables == bucketed,
              f"{gen}: bucket_tables {engine.bucket_tables}")
        vl = engine.packed_l.shape[0]
        deg = np.zeros(vl * size, np.int32)
        deg[: arrays.num_vertices] = arrays.degrees
        mesh.rest = _rest_words(rng, deg, device)
        wide = [0 if w is None else len(w.buckets) for w in engine.wide]
        items = [0 if w is None else w.work.shape[0] for w in engine.wide]
        k0 = engine._budget(int(arrays.max_degree) + 1)
        steps = []
        for planes in (1, engine.num_planes):
            for k in (k0, 12):
                words = _packed_words(rng, vl, min(int(arrays.max_degree),
                                                   40) + 1, 0.3)
                steps.append(_ring_held_steps(engine, k, planes, words))
        calls = {}
        for s in steps:
            for name, n in s["calls"].items():
                calls[name] = calls.get(name, 0) + n
        need = ["ring_stats", "ring_apply", "shard_finish"] + (
            ["ring_stats_wide"] if bucketed else [])
        check(all(calls.get(n, 0) > 0 for n in need),
              f"{gen}: held calls {calls}")
        if bucketed:
            check(all(wide), f"rmat: rotations without a K24 bucket {wide}")
        runs.append({"gen": gen, "bucketed": bucketed, "calls": calls,
                     "k24_buckets_per_rotation": wide,
                     "k24_items_per_rotation": items, "steps": steps})
        del engine
    err = _ring_edge_cases(device)
    return {"runs": runs, "max_abs_err": err}


def _ring_timing(engine, k: int, steps: int = 3) -> dict:
    """K23, K24 and K25 timed on this rank at the engine's shapes (world
    size 1) on mid-attempt words: the carry after ``steps`` supersteps of
    the attempt at budget ``k`` (fresh, confirmed and uncolored words;
    the attempt still running), through every launch of rotation 0 (K23's
    summed a superstep; K24's one launch, and K24 over each of its buckets
    alone, so the tail shows), then K25 from the accumulators they leave.
    Beside each, its plain version's time and its bound (bytes over the
    H100's 3.35 TB/s: ``_ring_bytes``; K25's ``_k25_bytes``, the touched
    words, with the dense figure beside). K24 is launched 50 more times
    from zeroed accumulators on the same inputs: the bytes must be the
    first launch's (its blocks OR with atomics)."""
    from dgc_tpu_torch.engine.base import AttemptStatus
    from dgc_tpu_torch.engine.fused import shard_superstep_epilogue
    from dgc_tpu_torch.kernels import ring as kr
    from dgc_tpu_torch.kernels import shard as ks

    vl = engine.packed_l.shape[0]
    planes = engine.num_planes
    ctrl0 = engine._start(k)
    for _ in range(steps):
        engine._superstep(ctrl0, k)
        shard_superstep_epilogue(engine, ctrl0, None)
    c = ctrl0.tolist()
    check(c[ks.CTRL_STATUS] == int(AttemptStatus.RUNNING)
          and c[ks.CTRL_STEP] == steps,
          f"the timed attempt is not running after {steps} supersteps: {c}")
    ctrl = ctrl0.clone()
    block = engine.blocks[0]
    block[:vl].copy_(engine.packed_l)
    window = 32 * planes
    fv = window >= engine.max_degree + 1 or k <= window
    words = engine.packed_l
    out = {"planes": planes, "timed_after_supersteps": steps,
           "words": {"uncolored": int((words < 0).sum()),
                     "fresh": int(((words >= 0) & (words & 1 == 1)).sum()),
                     "confirmed": int(((words >= 0)
                                       & (words & 1 == 0)).sum())},
           "launches_per_superstep": {}}
    narrow = engine.rot[0]
    if narrow is not None:
        def k23(f=kr.ring_stats):
            f(ctrl0, block, engine.packed_l, narrow, engine.acc, planes)

        out["k23_ms"] = _device_ms(k23, 10, "ring_stats_kernel")
        out["k23_plain_ms"] = _host_ms(lambda: k23(kr.ring_stats_reference),
                                       reps=2)
        b = _ring_bytes(engine, ctrl0, block, narrow.buckets, planes,
                        one_launch=True)
        out.update(k23_bytes=b, k23_bound_ms=b / HBM_BYTES_PER_S * 1e3,
                   k23_tables=len(narrow.buckets), k23_warps=narrow.warps)
        out["launches_per_superstep"]["k23"] = 1
    wide = engine.wide[0]
    if wide is not None:
        def k24(w=wide, f=kr.ring_stats_wide):
            f(ctrl0, block, engine.packed_l, w, engine.acc, planes)

        out["k24_ms"] = _device_ms(k24, 10, "ring_stats_wide_kernel")
        out["k24_plain_ms"] = _host_ms(
            lambda: k24(f=kr.ring_stats_wide_reference), reps=2)
        b = _ring_bytes(engine, ctrl0, block, wide.buckets, planes,
                        one_launch=True)
        out.update(k24_bytes=b, k24_bound_ms=b / HBM_BYTES_PER_S * 1e3,
                   k24_items=wide.work.shape[0], k24_chunk=wide.chunk)
        out["launches_per_superstep"]["k24"] = 1
        by_bucket = []
        for rows, table in wide.buckets:
            one = kr.WideTables([(None if rows is None else rows.cpu().numpy(),
                                  table.cpu().numpy())], vl, block.device,
                                wide.chunk)
            if one.work.shape[0] == 0:
                continue
            nb = _ring_bytes(engine, ctrl0, block, [(rows, table)], planes)
            by_bucket.append({
                "width": table.shape[1],
                "rows": (table.shape[0] if rows is None
                         else int((rows < vl).sum())),
                "items": one.work.shape[0],
                "ms": _device_ms(lambda w=one: k24(w), 10,
                                 "ring_stats_wide_kernel"),
                "bound_ms": nb / HBM_BYTES_PER_S * 1e3})
        out["k24_by_bucket"] = by_bucket
        # the atomics: 50 replays from zero, the first launch's bytes
        first = kr.new_acc(planes, vl, block.device)
        again = kr.new_acc(planes, vl, block.device)
        kr.ring_stats_wide(ctrl0, block, engine.packed_l, wide, first, planes)
        same = 0
        for _ in range(50):
            again.zero_()
            kr.ring_stats_wide(ctrl0, block, engine.packed_l, wide, again,
                               planes)
            same += int(torch.equal(again, first))
        check(same == 50, f"K24 replays: {same} of 50 equal the first")
        out["k24_replays_equal"] = same
        del first, again
    acc = engine.acc.clone()  # what the stats leave for K25

    def k25(fn=kr.ring_apply):
        ctrl.copy_(ctrl0)
        engine.acc.copy_(acc)
        fn(ctrl, engine.packed_l, engine.acc, engine.back, planes, k, fv)

    out["k25_ms"] = _device_ms(k25, 20, "ring_apply_kernel")
    out["k25_plain_ms"] = _host_ms(lambda: k25(kr.ring_apply_reference),
                                   reps=3)
    out.update(_k25_bytes(acc, planes))
    out.update(k25_bound_ms=out["k25_bytes"] / HBM_BYTES_PER_S * 1e3,
               k25_dense_bound_ms=out["k25_dense_bytes"]
               / HBM_BYTES_PER_S * 1e3)
    engine.acc.zero_()
    return out


def _k23_sweep(engine, k: int) -> dict:
    """``engine.sweep(k)`` with every K23 launch held against its plain
    version, then again under the profiler: K23's device time summed over
    the same launches, beside the bound over them (``_ring_bytes`` at each
    launch's state) and the plain versions' time."""
    from dgc_tpu_torch.kernels import ring as kr

    real = kr.ring_stats
    held = {"err": 0, "calls": 0, "bytes": 0, "plain_s": 0.0}

    def ring_stats(ctrl, block, packed, narrow, acc, planes):
        if int(ctrl[0]) == 0:  # RUNNING: a launch past the end moves nothing
            held["bytes"] += _ring_bytes(engine, ctrl, block, narrow.buckets,
                                         planes, one_launch=True)
        plain = acc.clone()
        torch.cuda.synchronize()
        t = time.perf_counter()
        kr.ring_stats_reference(ctrl, block, packed, narrow, plain, planes)
        torch.cuda.synchronize()
        held["plain_s"] += time.perf_counter() - t
        real(ctrl, block, packed, narrow, acc, planes)
        held["err"] = max(held["err"], _diff(acc, plain))
        held["calls"] += 1

    kr.ring_stats = ring_stats
    try:
        engine.sweep(k)
    finally:
        kr.ring_stats = real
    check(held["err"] == 0, f"K23 disagrees with its plain version over the "
                            f"sweep: max abs err {held['err']}")
    prof = _profiled(lambda: engine.sweep(k), {"ring_stats": held["calls"]},
                     names={"ring_stats": "ring_stats_kernel"})
    total, n, each = prof["ring_stats"]
    return {"k23_sweep_ms": total, "k23_sweep_launches": n,
            "k23_sweep_max_launch_ms": max(each) if each else None,
            "k23_sweep_bound_ms": held["bytes"] / HBM_BYTES_PER_S * 1e3,
            "k23_sweep_bytes": held["bytes"],
            "k23_sweep_plain_ms": held["plain_s"] * 1e3,
            "k23_sweep_held_err": held["err"]}


def _ring_ranks_run(out_dir: Path) -> dict:
    """``SHARD_RANKS_ARGS`` through the CLI at three gloo ranks, all on
    cuda:0 (children started as ``torchrun`` starts them), ``sharded`` and
    ``sharded-ring``: each rank's coloring JSON equal to the world-size-1
    run's under NCCL (``sharded``'s from ``_shard_ranks_run``,
    ``sharded-ring``'s here), each rank's peak memory a backend, and one
    rotation's host time. At world size 1 a ring sends nothing, so this
    is the only run where the card's tensors go through
    ``VertexMesh.rotate`` (the staged route: gloo's point-to-point takes
    no card tensor)."""
    import os
    import socket

    from dgc_tpu_torch import cli

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    v = int(SHARD_RANKS_ARGS[SHARD_RANKS_ARGS.index("--node-count") + 1])
    procs = []
    t = time.perf_counter()
    for rank in range(RING_RANKS):
        d = out_dir / f"ring-ranks-{rank}"
        d.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(RING_RANKS), MASTER_ADDR="127.0.0.1",
                   LOCAL_WORLD_SIZE=str(RING_RANKS), MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RING_RANK_SCRIPT, str(d), str(v),
             *SHARD_RANKS_ARGS],
            cwd=Path(__file__).resolve().parent, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    one = out_dir / "ranks-world1"
    check(cli.main(SHARD_RANKS_ARGS + [
        "--backend", "sharded-ring", "--output-coloring",
        str(one / "sharded-ring.json")]) == 0, "sharded-ring: world size 1")
    check(filecmp.cmp(one / "sharded-ring.json", one / "sharded.json",
                      shallow=False),
          "sharded-ring's world-size-1 coloring differs from sharded's")
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise SmokeFailure("the three-rank run did not end in 600 s")
        outs.append((p.returncode, so, se))
    wall = time.perf_counter() - t
    per_rank = []
    for rank, (rc, so, se) in enumerate(outs):
        check(rc == 0, f"rank {rank} of the three-rank run exited {rc}: "
                       f"{se.strip().splitlines()[-3:]}")
        info = json.loads(so.strip().splitlines()[-1])
        check(info["backend"] == "gloo" and info["staged"],
              f"rank {rank}: {info}")
        for backend in ("sharded", "sharded-ring"):
            check(filecmp.cmp(out_dir / f"ring-ranks-{rank}" /
                              f"{backend}.json", one / f"{backend}.json",
                              shallow=False),
                  f"rank {rank}'s {backend} coloring differs from the "
                  f"world-size-1 run's")
        per_rank.append(info)
    return {"phase": "ring_three_ranks", "graph": " ".join(SHARD_RANKS_ARGS),
            "backend": "gloo on cuda:0 (staged rotations)", "wall_s": wall,
            "ranks": per_rank,
            "attempt_lines": [line for line in outs[0][1].splitlines()
                              if line.startswith("attempt:")]}


def phase_ring_main(card: str, out_dir: Path, main_runs: dict,
                    rmat_runs: dict, graphs: dict) -> dict:
    """``sharded-ring`` through the CLI's calls at world size 1 under
    NCCL: the flat layout on the 1M uniform draw, the bucketed one on the
    1M RMAT draw (``graphs``: the two draws, ``cli.load_graph``'s, by
    ``--gen-method``). The launch counts are zeroed just before each sweep and
    read just after, and each must launch every kernel of its path (K23,
    K25, K21, K22; K24 on RMAT); the coloring JSON and the attempts must
    be ``ell``'s (``ell-bucketed``'s) on the same draw. Then K23-K25 timed
    (``_ring_timing``), two supersteps of the same engine with every
    launch held (``_ring_world1_held``), the held supersteps at shard 3 of 4
    (``phase_ring_kernels``), a telemetry run (``--run-manifest``: K21's
    recording variant) and the three-rank gloo run (``_ring_ranks_run``).
    At world size 1 a ring sends nothing (one rotation, no call), so the
    three-rank run is the only place the card's tensors go through
    ``VertexMesh.rotate``."""
    from dgc_tpu_torch import cli
    from dgc_tpu_torch.kernels import ring as kr
    from dgc_tpu_torch.kernels import shard as ks

    runs = {}
    for argv, bucketed, ref_name in ((MAIN_ARGS, False, "ell"),
                                     (RMAT_ARGS, True, "ell-bucketed")):
        args = cli.build_parser().parse_args(
            argv + ["--output-coloring", str(out_dir / "coloring.json"),
                    "--backend", "sharded-ring"])
        graph = graphs[args.gen_method]  # phase_sharded_main's draw
        t = time.perf_counter()
        engine = cli.make_engine(args, graph)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t
        check(engine.bucket_tables == bucketed,
              f"{args.gen_method}: bucket_tables {engine.bucket_tables}")
        torch.cuda.reset_peak_memory_stats()
        for mod in (ks, kr):
            mod.reset_launch_counts()
        timed = _TimedSweepEngine(engine)
        result = cli.sweep(args, graph, timed)
        torch.cuda.synchronize()
        launches = _shard_kernels(ks) | dict(kr.launch_counts)
        ref = (main_runs if args.gen_method == "fast" else rmat_runs)[ref_name]
        path = out_dir / f"coloring-{args.gen_method}-sharded-ring.json"
        graph.save_coloring(str(path), result.colors)
        check(filecmp.cmp(path, out_dir / f"coloring-{args.gen_method}-"
                                          f"{ref_name}.json", shallow=False),
              f"sharded-ring on {args.gen_method}: the coloring JSON "
              f"differs from {ref_name}'s")
        attempts = [[a.k, a.status.name, a.supersteps, a.colors_used]
                    for a in result.attempts]
        check(attempts == [list(a) for a in ref["attempts"]],
              f"sharded-ring: attempts {attempts}, {ref_name} "
              f"{ref['attempts']}")
        need = ["ring_stats", "ring_apply", "shard_finish", "shard_pair"] + (
            ["ring_stats_wide"] if bucketed else [])
        check(all(launches[n] > 0 for n in need),
              f"sharded-ring {args.gen_method}: the sweep skipped a kernel "
              f"of its path: {launches}")
        rec = {"phase": "ring_main", "backend": "sharded-ring",
               "graph": " ".join(argv), "bucket_tables": bucketed,
               "engine_build_s": build_s,
               "sweep_s": result.wall_time_s - result.post_reduce_s,
               "attempt_s": timed.seconds,
               "supersteps": result.total_supersteps,
               "attempts": attempts, "launches": launches,
               "colors_after_post_pass": result.minimal_colors,
               "ell_sweep_s": ref["sweep_s"],
               # the default engine's sweep calls in the same run, beside
               "ell_compact_attempt_s": (
                   main_runs if args.gen_method == "fast"
                   else rmat_runs)["ell-compact"]["attempt_s"],
               "confirm_resumed_from_step": engine.resumed_from_step,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "card": card}
        k0 = engine._budget(graph.initial_k())
        rec.update(_k23_sweep(engine, k0))
        rec.update(_ring_timing(engine, k0))
        rec["held"] = _ring_world1_held(engine, k0, bucketed)
        emit(rec)
        runs[args.gen_method] = rec
        del engine, timed
    t = time.perf_counter()
    held = phase_ring_kernels("cuda", {g: graph.arrays
                                       for g, graph in graphs.items()})
    emit({"phase": "ring_kernels_vs_plain", **held,
          "seconds": time.perf_counter() - t})
    # telemetry on: K21's recording variant, the coloring unchanged
    d = out_dir / "ring-telemetry"
    d.mkdir(parents=True, exist_ok=True)
    for mod in (ks, kr):
        mod.reset_launch_counts()
    rc = cli.main(MAIN_ARGS + ["--backend", "sharded-ring",
                               "--output-coloring", str(d / "colors.json"),
                               "--log-json", str(d / "run.jsonl"),
                               "--run-manifest", str(d / "manifest.json"),
                               "--metrics-prom", str(d / "metrics.prom")])
    torch.cuda.synchronize()
    tel = _shard_kernels(ks) | dict(kr.launch_counts)
    check(rc == 0 and tel["shard_finish_rec"] > 0
          and tel["shard_finish"] == 0 and tel["ring_stats"] > 0
          and tel["ring_apply"] > 0, f"telemetry run: rc {rc}, {tel}")
    check(filecmp.cmp(d / "colors.json",
                      out_dir / "coloring-fast-sharded-ring.json",
                      shallow=False), "telemetry on changed the coloring")
    files = _check_telemetry_files("sharded-ring", d, False)
    ranks = _ring_ranks_run(out_dir)
    emit(ranks)
    return {"runs": runs, "held": held, "telemetry_launches": tel,
            "telemetry": files, "ranks": ranks}


def ring_kernels_line(ring: dict) -> list[dict]:
    """K23-K25: launches on the 1M uniform ``sharded-ring`` sweep (K24 on
    the 1M RMAT one; the other run's beside), time, plain time and bound
    at that path's shapes; K24's time bucket by bucket and its replays,
    K25's on the RMAT run and its dense figure beside."""
    src = "dgc_tpu_torch/csrc/ring.cu"
    err = ring["held"]["max_abs_err"]

    def entry(name, key, gen, replaces):
        run = ring["runs"][gen]
        other = ring["runs"]["rmat" if gen == "fast" else "fast"]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": run["launches"][name],
                "launches_other": {"rmat" if gen == "fast" else "fast":
                                   other["launches"][name]},
                "max_abs_err": err, "ms": run[f"{key}_ms"],
                "plain_ms": run[f"{key}_plain_ms"],
                "bound_ms": run[f"{key}_bound_ms"], "bound_by": "bytes",
                "library_ms": None}

    rmat = ring["runs"]["rmat"]
    k23 = entry("ring_stats", "k23", "fast", "dgc_tpu/engine/ring.py:303")
    k23["max_abs_err"] = max([err] + [r["k23_sweep_held_err"]
                                      for r in ring["runs"].values()])
    k23["sweeps"] = {gen: {key: r[f"k23_{key}"] for key in (
        "ms", "plain_ms", "bound_ms", "sweep_ms", "sweep_launches",
        "sweep_bound_ms", "sweep_plain_ms", "sweep_max_launch_ms")}
        for gen, r in ring["runs"].items()}
    k24 = entry("ring_stats_wide", "k24", "rmat",
                "dgc_tpu/engine/ring.py:355")
    k24.update(by_bucket=rmat["k24_by_bucket"],
               replays_equal=rmat["k24_replays_equal"])
    k25 = entry("ring_apply", "k25", "fast", "dgc_tpu/engine/ring.py:310")
    k25.update(dense_bound_ms=ring["runs"]["fast"]["k25_dense_bound_ms"],
               rmat={key: rmat[f"k25_{key}"] for key in
                     ("ms", "plain_ms", "bound_ms", "dense_bound_ms")})
    return [k23, k24, k25]


# ---- the lane-sharded serve tier (B12g): the partial K15/K16 and their tail
# (K26's fold), the mesh instances of K18/K19 -------------------------------

# shard counts of the held mesh cases; lanes a shard, width, rows
MESH_SHARDS = (2, 4, 8)
MESH_LANES = ((4, 8, 3000), (2, 64, 1200))


def _mesh_of(n: int, device):
    from dgc_tpu_torch.serve.batched import lane_mesh_over

    return lane_mesh_over([torch.device(device)] * n)


def _plain_fold(plain, i: int, ran: bool) -> bool:
    """After shard ``i``'s plain partial K15/K16 (no mesh): where it is the
    mesh's last shard and its tail ran (``ran``: K16 always, K15 in a live
    round), the plain fold over every shard (``lane_mesh_fold_reference``),
    what the kernels' tail must equal. Returns whether it folded."""
    from dgc_tpu_torch.kernels import serve as ks

    if not ran or i != plain.n - 1:
        return False
    ks.lane_mesh_fold_reference([L.ctrl for L in plain.shards])
    return True


def _mesh_ctrl_diff(kern, plain, ticket: int) -> int:
    """Every shard's control block, the kernels' against the plain twin's,
    but the mesh ticket, which the plain twin never takes: on the card
    shard 0's must be ``ticket`` (across cards the shards whose tail ran
    this round, 0 once the last folded; on one card always 0), the
    others' 0."""
    from dgc_tpu_torch.kernels import serve as ks

    t = ks.CTRL_MESH_TICKET
    got = [int(L.ctrl[t]) for L in kern.shards]
    check(got == [ticket] + [0] * (kern.n - 1),
          f"the mesh ticket: {got}, want {ticket} in shard 0")
    return max(_diff(k_.ctrl[:t], p_.ctrl[:t])
               for k_, p_ in zip(kern.shards, plain.shards))


def _mesh_serve_case(rng, n: int, b: int, w: int, v: int, staged: bool,
                     timing: bool, armed: bool, device) -> int:
    """n shards of ``_serve_lanes``' random lanes as a lane mesh, the last
    shard's lanes all dead and unflagged (its fold adds the identities):
    the partial K16 on each shard, the last folding in its tail, then
    ``SERVE_ROUNDS`` rounds of each shard's K14 (staged), K13 and partial
    K15 (the last folding where the round is live), every shard's buffers
    held against the plain versions after every launch (the clock slots by
    ``_serve_diff``'s rule), every control block against the plain partial
    plus the plain fold (``_plain_fold``, ``_mesh_ctrl_diff``), and the
    folds the card counted (``mesh_folds``) against the plain ones.
    Returns the max abs error."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.layout import CARRY_PHASE, T_PREV, T_US

    pairs = [_serve_lanes(rng, b, w, v, staged, device, armed)
             for _ in range(n)]
    for L in pairs[-1]:
        L.carry[CARRY_PHASE].fill_(2)
        L.reset.zero_()
    kern = ks.new_mesh_lanes([k for k, _p in pairs])
    plain = ks.new_mesh_lanes([p for _k, p in pairs])
    worst, folds = 0, 0
    folds0 = ks.mesh_folds()
    t = ks.CTRL_MESH_TICKET
    for i, (k_, p_) in enumerate(pairs):
        before = [c.clone() for c in p_.carry]
        ks.lane_reset(k_, timing, mesh=kern)
        ks.lane_reset_reference(p_, timing, partial=True)
        folds += _plain_fold(plain, i, True)
        worst = max(worst, _serve_diff(k_, p_, (T_PREV,) if timing else (),
                                       before, t),
                    _mesh_ctrl_diff(kern, plain, 0))
    steps = ((ks.lane_compact, ks.lane_compact_reference, False),
             (ks.lane_superstep, ks.lane_superstep_reference, False),
             (ks.lane_finish, ks.lane_finish_reference, True))
    for _ in range(SERVE_ROUNDS):
        live = bool(int(plain.ctrl[ks.CTRL_LIVE]))
        for i, (k_, p_) in enumerate(pairs):
            for launch, reference, last in steps:
                if launch is ks.lane_compact and not staged:
                    continue
                before = [c.clone() for c in p_.carry]
                if last:
                    launch(k_, timing, mesh=kern)
                    reference(p_, timing, partial=True)
                    folds += _plain_fold(plain, i, live)
                else:
                    launch(k_)
                    reference(p_)
                worst = max(worst, _serve_diff(
                    k_, p_, (T_US, T_PREV) if timing and last else (),
                    before, t))
            worst = max(worst, _mesh_ctrl_diff(kern, plain, 0))
    check(ks.mesh_folds() - folds0 == folds,
          f"the card folded {ks.mesh_folds() - folds0} times, the plain "
          f"twin {folds}")
    torch.cuda.synchronize()
    return worst


def _mesh_carry_case(rng, n: int, per_old: int, per_new: int, v: int,
                     w: int, a0: int, device) -> int:
    """The sharded seat, permute and resize twins on a mesh of ``n`` slots
    on the card against the same twins on ``n`` CPU slots (the plain
    versions): a seat wave over several shards (a lane twice), kept lanes
    in random order crossing shards, sources past the old width. Returns
    the max abs error."""
    from dgc_tpu_torch.layout import CARRY_LEN
    from dgc_tpu_torch.serve import batched as sb

    card, host = _mesh_of(n, device), _mesh_of(n, "cpu")
    b_old, b_new = n * per_old, n * per_new
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32))
    carry = [rng.integers(-5, 1 << 20, size=(b_old, a0) if j == 18 else
                          (b_old, v) if j in (2, 6, 10) else (b_old,))
             for j in range(CARRY_LEN)]
    stacks = [rng.integers(0, 1 << 30, size=(b_old, v, w)),
              rng.integers(0, w + 1, size=(b_old, v)),
              rng.integers(1, w + 2, size=b_old),
              rng.integers(4, 4000, size=b_old), np.zeros(b_old)]

    def shards(arrays, mesh):
        return [[t(a[i * per_old:(i + 1) * per_old]).to(d) for a in arrays]
                for i, d in enumerate(mesh.devices)]

    def whole(parts):
        return [torch.cat([p[j].cpu() for p in parts])
                for j in range(len(parts[0]))]

    keep = int(rng.integers(0, min(b_old, b_new) + 1))
    src = [int(x) for x in rng.permutation(b_old)[:keep]]
    dst = list(range(keep))
    got = sb.permute_carry_kernel_sharded(card, shards(carry, card), src, dst,
                                          b_new)
    want = sb.permute_carry_kernel_sharded(host, shards(carry, host), src,
                                           dst, b_new)
    worst = max(_diff(x.cpu(), y) for x, y in zip(whole(got), whole(want)))
    dummy = rng.integers(0, 1 << 30, size=(v, w))
    rsrc = src + [b_old] * (b_new - keep)
    got = sb.resize_inputs_kernel_sharded(card, shards(stacks, card), rsrc,
                                          t(dummy).to(device), 777)
    want = sb.resize_inputs_kernel_sharded(host, shards(stacks, host), rsrc,
                                           t(dummy), 777)
    worst = max([worst] + [_diff(x.cpu(), y)
                           for x, y in zip(whole(got), whole(want))])
    lanes = [int(x) for x in rng.choice(b_old, size=min(b_old, 5),
                                        replace=False)]
    lanes.append(lanes[0])   # a lane seated twice: the last seat wins
    seats = [(lane, rng.integers(0, 1 << 30, size=(v, w)).astype(np.int32),
              rng.integers(0, w + 1, size=v).astype(np.int32),
              int(rng.integers(1, w + 2)), int(rng.integers(4, 4000)))
             for lane in lanes]
    on_card, on_host = shards(stacks, card), shards(stacks, host)
    sb.seat_lane_kernel_sharded(card, on_card, seats)
    sb.seat_lane_kernel_sharded(host, on_host, seats)
    worst = max([worst] + [_diff(x.cpu(), y) for x, y in
                           zip(whole(on_card), whole(on_host))])
    torch.cuda.synchronize()
    return worst


def phase_mesh_kernels(device) -> int:
    """The lane mesh's kernels against their plain versions on the card,
    exact: the partial K16/K15 and the fold in their tail (K26) on meshes
    of ``MESH_SHARDS`` slots of ``MESH_LANES`` (staged and not, timing and
    the speculation vectors on in some), each with a shard of dead lanes;
    no standalone K26 launch; the sharded seat (K17 a
    shard), permute and resize (the mesh K18/K19) on random carries and
    stacks growing, keeping and shrinking, lanes crossing shards. Returns
    the max abs error."""
    from dgc_tpu_torch.kernels import carry as kcar
    from dgc_tpu_torch.kernels import serve as ks

    rng = np.random.default_rng(53)
    worst = 0
    ks.reset_launch_counts()
    kcar.reset_launch_counts()
    for n in MESH_SHARDS:
        for b, w, v in MESH_LANES:
            for staged, timing, armed in ((False, False, False),
                                          (True, False, True),
                                          (True, True, False)):
                worst = max(worst, _mesh_serve_case(
                    rng, n, b, w, v, staged, timing, armed, device))
        for per_old, per_new in ((2, 2), (1, 4), (4, 1)):
            worst = max(worst, _mesh_carry_case(rng, n, per_old, per_new,
                                                2048, 8, 8, device))
    check(worst == 0, f"the lane mesh's kernels differ from their plain "
          f"versions by {worst}")
    folds = ks.mesh_folds()
    partial = dict(ks.partial_launch_counts)
    check(folds > 0 and all(v_ > 0 for v_ in partial.values())
          and "lane_mesh_fold" not in ks.launch_counts
          and kcar.launch_counts["carry_permute_mesh"] > 0
          and kcar.launch_counts["inputs_resize_mesh"] > 0,
          f"a mesh kernel never launched: folds {folds}, partial {partial}, "
          f"launches {ks.launch_counts}, carry {kcar.launch_counts}")
    emit({"phase": "mesh_kernels", "max_abs_err": worst, "folds": folds,
          "partial": partial, "carry": dict(kcar.launch_counts)})
    return worst


def _mesh_lanes(inputs, cls, stages, devices: list):
    """A fresh lane mesh of ``inputs`` for a sweep: the lanes split evenly
    over slots on ``devices`` (one a slot)."""
    from dgc_tpu_torch.kernels import serve as ks

    per = inputs[1].shape[0] // len(devices)
    return ks.new_mesh_lanes([_serve_lanes_of(
        tuple(x[i * per:(i + 1) * per] for x in inputs), cls, stages, d,
        ks.INT32_MAX) for i, d in enumerate(devices)])


# the partial (kPartial) instances of K16 and K15 without the clock, as
# the profiler names them
_PARTIAL_NAMES = {"lane_reset": "lane_reset_kernel<false, true>",
                  "lane_finish": "lane_finish_kernel<false, true>"}


def _mesh_partial_timing(h: dict, cls, stages, device) -> dict:
    """The partial K16/K15 apart, at the shape ``h`` (a held mesh sweep,
    clock off) held them: one whole sweep of its inputs over as many slots
    on ``device``, launched as the mesh path launches it, under the
    profiler with its names filtered to the partial instances (the launch
    counts from one unprofiled sweep). ``plain_ms`` and ``bound_ms``: the
    held sweep's plain seconds and bytes a launch."""
    from dgc_tpu_torch.kernels import serve as ks

    staged = stages is not None

    def sweep(M):
        ks.mesh_reset(M)
        while int(M.ctrl[ks.CTRL_LIVE]):
            ks.mesh_superstep(M, staged)

    def make():
        return _mesh_lanes(h["inputs"], cls, stages,
                           [torch.device(device)] * h["slots"])

    before = dict(ks.partial_launch_counts)
    sweep(make())
    torch.cuda.synchronize()
    want = {k_: ks.partial_launch_counts[k_] - before[k_] for k_ in before}
    sums = _profiled(sweep, want, _DEVICE_MS_KEPT, _PARTIAL_NAMES,
                     prepare=make)
    mean = lambda xs: sum(xs) / len(xs)
    return {name: {"ms": sums[name][0] / sums[name][1],
                   "profiled_launches": sums[name][1], "launches": want[name],
                   "held_launches": len(h["bytes"][name]),
                   "plain_ms": mean(h["plain_s"][name]) * 1e3,
                   "bound_ms": mean(h["bytes"][name]) / HBM_BYTES_PER_S * 1e3,
                   "library_ms": None,
                   "shape": f"{h['slots']} slots of "
                            f"{h['inputs'][1].shape[0] // h['slots']} lanes "
                            f"of {cls.name}, a whole sweep"}
            for name in _PARTIAL_NAMES}


def _held_mesh_sweep(inputs, cls, stages, devices: list, timing: bool,
                     slice_steps: int | None) -> dict:
    """One sweep of ``inputs`` over lane slots on ``devices`` (one a slot,
    repeats allowed), launched as the mesh path launches it
    (``mesh_reset``, ``mesh_superstep``): each shard's partial K16, the
    last folding in its tail, then until the folded live word drops each
    shard's K14 (staged), K13 and partial K15, the last folding. Whole, as
    sync mode runs it, or (``slice_steps``) as continuous mode does: a
    slice of at most that many supersteps, then the next from where it
    stopped (reset flags down) until no lane is live. Every launch is held
    against its plain version on a twin mesh: each shard's buffers after
    each K13-K16 (the clock slots by ``_serve_diff``'s rule), and after each
    partial K15/K16 every shard's control block against the plain partials
    plus the plain fold once the last shard's ran (``_plain_fold``,
    ``_mesh_ctrl_diff``). ``folds`` counts the plain folds,
    ``kernel_folds`` the card's (``mesh_folds``), ``changed`` the folds
    that moved a word of some shard's control block (a fold that wrote
    nothing fails on those)."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.layout import CARRY_PHASE, T_PREV, T_US

    n = len(devices)
    ks.enable_peer_access(devices)

    def sync():  # the last shard's tail writes the other cards' words
        for d in set(devices):
            torch.cuda.synchronize(d)

    kern, plain = (_mesh_lanes(inputs, cls, stages, devices) for _ in "kp")
    out = {"worst": 0, "rounds": 0, "changed": 0, "folds": 0, "kern": kern,
           "plain": plain, "held": dict.fromkeys(_SERVE_KERNELS, 0),
           "inputs": inputs, "slots": n,
           # the partial K16/K15: each launch's bytes and plain seconds
           "bytes": {"lane_reset": [], "lane_finish": []},
           "plain_s": {"lane_reset": [], "lane_finish": []}}
    clocks = {"lane_reset": (T_PREV,), "lane_finish": (T_US, T_PREV)}
    t_word = ks.CTRL_MESH_TICKET
    folds0 = ks.mesh_folds()

    def shard(i, launch, reference):
        k_, p_ = kern.shards[i], plain.shards[i]
        name = launch.__name__
        partial = name in clocks
        before = [c.clone() for c in p_.carry]
        # the tail runs: K16 always, K15 in a live round
        ran = name == "lane_reset" or bool(int(p_.ctrl[ks.CTRL_LIVE]))
        with ks.current_card(k_.device):
            if partial:
                launch(k_, timing, mesh=kern)
                state = _serve_state(p_)
                torch.cuda.synchronize()
                t = time.perf_counter()
                reference(p_, timing, partial=True)
                torch.cuda.synchronize()
                out["plain_s"][name].append(time.perf_counter() - t)
                out["bytes"][name].append(_serve_bytes(p_, name, state))
                partials = [L.ctrl.clone() for L in plain.shards]
                if _plain_fold(plain, i, ran):
                    out["folds"] += 1
                    out["changed"] += any(
                        not torch.equal(a_[:t_word], L.ctrl[:t_word])
                        for a_, L in zip(partials, plain.shards))
            else:
                launch(k_)
                reference(p_)
        out["worst"] = max(out["worst"], _serve_diff(
            k_, p_, clocks.get(name, ()) if timing else (), before, t_word))
        if partial:
            sync()
            out["worst"] = max(out["worst"], _mesh_ctrl_diff(
                kern, plain, (i + 1) % n if ran and kern.spread else 0))
        out["held"][name] += 1

    out["slices"] = 0
    while True:
        if slice_steps is not None:
            kern.set_budget(slice_steps)
            plain.set_budget(slice_steps)
        for i in range(n):
            shard(i, ks.lane_reset, ks.lane_reset_reference)
        while int(plain.ctrl[ks.CTRL_LIVE]):
            for i in range(n):
                if stages is not None:
                    shard(i, ks.lane_compact, ks.lane_compact_reference)
                shard(i, ks.lane_superstep, ks.lane_superstep_reference)
                shard(i, ks.lane_finish, ks.lane_finish_reference)
            out["rounds"] += 1
        out["slices"] += 1
        if slice_steps is None or not any(
                bool((L.carry[CARRY_PHASE] < 2).any()) for L in plain.shards):
            break
        for L in kern.shards + plain.shards:
            L.reset.zero_()
    sync()
    out["kernel_folds"] = ks.mesh_folds() - folds0
    return out


# the held mesh sweeps at the serving class: (slots, timing, slice size:
# "priced" as continuous mode prices it at batch 8 (longer than a sweep),
# a number (the budget cuts the sweep: slices resume it), or None (whole,
# as sync mode runs it))
MESH_HELD = ((4, False, "priced"), (4, False, 7), (4, True, "priced"),
             (2, False, None))


def _held_mesh_sweeps(graphs: list, devices_of) -> tuple:
    """``_held_mesh_sweep`` at the serving class, once for each of
    ``MESH_HELD`` (``devices_of(slots)``: the slots' devices): the first
    8 uniform 20k requests (the main path's batch) padded into their class
    (v32768w32, the auto ladder). Checks every launch exact, the card's
    folds as many as the plain twin's and some moving a word in each sweep,
    a sweep resumed across slices, and every K15 of the sweeps the partial
    instance. Returns (class, stages, lanes, slice size, the sweeps)."""
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.serve.batched import auto_slice_steps
    from dgc_tpu_torch.serve.shape_classes import (DEFAULT_LADDER,
                                                   pad_member,
                                                   stage_schedule_for)

    b = 8
    graphs = graphs[:b]
    cls = DEFAULT_LADDER.class_for(max(g.num_vertices for g in graphs),
                                   max(g.max_degree for g in graphs))
    stages = stage_schedule_for(cls, "auto")
    members = [pad_member(g.arrays, cls) for g in graphs]
    inputs = tuple(torch.from_numpy(np.stack(x)) for x in (
        [m.comb for m in members], [m.degrees for m in members],
        [np.int32(m.k0) for m in members],
        [np.int32(m.max_steps) for m in members]))
    partial0 = dict(ks.partial_launch_counts)
    held = {}
    steps = auto_slice_steps(cls.entries(), b, "gpu")
    for slots, timing, size in MESH_HELD:
        size = steps if size == "priced" else size
        h = _held_mesh_sweep(inputs, cls, stages, devices_of(slots), timing,
                             size)
        held[f"{slots} slots" + (", timing" if timing else "")
             + (f", slices of {size}" if size else ", whole")] = h
    worst = max(h["worst"] for h in held.values())
    partial = {k_: ks.partial_launch_counts[k_] - partial0[k_]
               for k_ in partial0}
    check(worst == 0 and all(h["changed"] > 0 for h in held.values())
          and all(h["kernel_folds"] == h["folds"] for h in held.values())
          and any(h["slices"] > 1 for h in held.values())
          and partial["lane_finish"] == sum(h["held"]["lane_finish"]
                                            for h in held.values()),
          f"the held mesh sweeps at {cls.name}: error {worst}, folds "
          f"{[(h['kernel_folds'], h['folds']) for h in held.values()]}, "
          f"folds that moved a word {[h['changed'] for h in held.values()]},"
          f" partial launches {partial}")
    return cls, stages, b, steps, held


def _held_record(held: dict) -> dict:
    return {k_: {"rounds": h["rounds"], "slices": h["slices"],
                 "launches": h["held"], "folds": h["kernel_folds"],
                 "folds_that_moved_a_word": h["changed"]}
            for k_, h in held.items()}


def _fold_cost(h: dict, cls, stages, device, reps: int = 10,
               fold: bool = True) -> dict:
    """The fold's cost in the partial K15's tail, at the shape the held
    mesh sweep ``h`` ran: a fresh mesh of its inputs run to its first
    superstep's last K15, whose buffers (that shard's carry, ``nxt`` and
    counters, every control block) are kept;
    that K15 replayed ``reps`` times from them as the shard's partial alone
    (``alone_ms``) and, with ``fold``, as the mesh's last shard, which
    folds (``ms``), each under the profiler (its device time a launch).
    ``bound_ms``: the fold's bytes (each shard's partial rung and live
    word, the steps and budget read once; four words written into each
    control block, and the count). Without ``fold`` (a package
    whose K15 has no fold in its tail) the other shards run their partial
    alone and only ``alone_ms`` is taken."""
    from dgc_tpu_torch.kernels import serve as ks

    M = _mesh_lanes(h["inputs"], cls, stages,
                    [torch.device(device)] * h["slots"])
    ks.mesh_reset(M)
    for L in M.shards:
        if stages is not None:
            ks.lane_compact(L)
        ks.lane_superstep(L)
    for L in M.shards[:-1]:
        ks.lane_finish(L, **({"mesh": M} if fold else {"partial": True}))
    last = M.shards[-1]
    bufs = list(last.carry) + [last.nxt, last.scratch] + [
        L.ctrl for L in M.shards]
    kept = [t_.clone() for t_ in bufs]
    n = M.n
    check(int(last.ctrl[ks.CTRL_LIVE]) == 1,
          f"the fold's cost: the last K15 of a live round not reached "
          f"({M.shards[0].ctrl.tolist()})")

    def replay(**kw):
        def run():
            for t_, k_ in zip(bufs, kept):
                t_.copy_(k_)
            ks.lane_finish(last, partial=True, **kw)
        return run

    name = _PARTIAL_NAMES["lane_finish"]
    out = {"alone_ms": _kernel_ms(replay(), name, reps),
           "shape": f"{n} shards of {last.b} lanes of {cls.name}, the "
                    f"last shard's K15 of the first superstep"}
    if fold:
        folds = ks.mesh_folds()
        out["ms"] = _kernel_ms(replay(mesh=M), name, reps)
        made = ks.mesh_folds() - folds  # a replay each (a window or more)
        check(made > 0 and made % reps == 0,
              f"the fold's cost: {made} folds in windows of {reps} replays")
        out["added_ms"] = out["ms"] - out["alone_ms"]
        out["bound_ms"] = (2 * n + 2 + 4 * n + 1) * 4 / HBM_BYTES_PER_S * 1e3
    return out


def measure_mesh(card: str, graphs: list, device: str = "cuda") -> dict:
    """The lane mesh's kernels at the serving class's shapes: the first
    8 uniform 20k requests (the main path's batch) padded into their class
    (v32768w32, the auto ladder). (1) Held sweeps (``_held_mesh_sweep``,
    ``MESH_HELD``) over 4 slots of 2 lanes and over 2 slots of 4:
    every partial K16/K15, K13 and K14 launch exact against its plain
    version, and every fold in the partial K15/K16's tail against the plain
    fold; some fold must move a word. (2) The fold's cost in the tail
    (``_fold_cost``). (3) The mesh K18/K19 growing a 4-slot
    pool 8 → 32 lanes, all 8 kept (the batch-32 ramp: new shard 0 gathers
    a lane from every old shard), on random words, held exact. ``ms``
    device time from ``torch.profiler`` (one launch: K18/K19 into new
    shard 0), ``plain_ms`` the plain version's host wall on the card,
    ``bound_ms`` the launch's bytes (each input word read once, each
    output word written once) over 3.35 TB/s, ``library_ms`` PyTorch
    calls doing the same where there are (K18/K19: the old shards
    concatenated, then an indexed copy per slot or stack)."""
    from dgc_tpu_torch.kernels import carry as kcar
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.layout import CARRY_LEN
    from dgc_tpu_torch.serve.batched import stage_idx_width

    cls, stages, b, steps, held = _held_mesh_sweeps(
        graphs, lambda slots: [torch.device(device)] * slots)
    worst = max(h["worst"] for h in held.values())
    v, w = cls.v_pad, cls.w_pad
    a0 = stage_idx_width(stages)
    n = 4
    P = held[f"4 slots, slices of {steps}"]["plain"]
    fold = _fold_cost(held[f"4 slots, slices of {steps}"], cls, stages,
                      device)
    fold["plain_ms"] = _host_ms(lambda: ks.lane_mesh_fold_reference(
        [L.ctrl for L in P.shards]), 3)
    gen = torch.Generator(device=device)
    gen.manual_seed(59)

    def rand(shape):
        return torch.randint(0, 1 << 30, shape, generator=gen,
                             dtype=torch.int32, device=device)

    per_old, per_new = b // n, 32 // n
    olds = [[rand((per_old, a0) if j == 18 else
                  (per_old, v) if j in (2, 6, 10) else (per_old,))
             for j in range(CARRY_LEN)] for _ in range(n)]
    rows = [(i // per_old, i % per_old) for i in range(b)] + \
        [(-1, -1)] * (per_new - b)
    got = kcar.carry_permute_mesh(olds, rows, per_new, device)
    worst = max([worst] + [_diff(x, y) for x, y in zip(
        got, kcar.carry_permute_mesh_reference(olds, rows, per_new, device))])
    idx = torch.arange(b, dtype=torch.int64, device=device)
    out = [torch.empty_like(t_) for t_ in got]

    def indexed():
        for j, o in enumerate(out):
            o[:b] = torch.cat([old[j] for old in olds]).index_select(0, idx)

    carry_row = (3 * v + a0 + 16) * 4
    permute = {
        "ms": _kernel_ms(lambda: kcar.carry_permute_mesh(olds, rows, per_new,
                                                         device),
                         "carry_permute_mesh_kernel"),
        "plain_ms": _host_ms(lambda: kcar.carry_permute_mesh_reference(
            olds, rows, per_new, device), 3),
        "bound_ms": (b + per_new) * carry_row / HBM_BYTES_PER_S * 1e3,
        "library_ms": _cuda_ms(indexed, 10),
        "shape": f"{n} shards, {b} -> 32 lanes of {cls.name}: new shard 0 "
                 f"({per_new} lanes, {b} kept from {n} old shards)"}

    stacks = [[rand((per_old, v, w)), rand((per_old, v)), rand((per_old,)),
               rand((per_old,))] for _ in range(n)]
    dummy = rand((v, w))
    got = kcar.inputs_resize_mesh(stacks, rows, dummy, 1, 2 * v + 4, device)
    worst = max([worst] + [_diff(x, y) for x, y in zip(
        got, kcar.inputs_resize_mesh_reference(stacks, rows, dummy, 1,
                                               2 * v + 4, device))])
    src_l = torch.tensor(list(range(b)) + [b] * (per_new - b),
                         dtype=torch.int64, device=device)
    resize = {
        "ms": _kernel_ms(lambda: kcar.inputs_resize_mesh(
            stacks, rows, dummy, 1, 2 * v + 4, device),
            "inputs_resize_mesh_kernel"),
        "plain_ms": _host_ms(lambda: kcar.inputs_resize_mesh_reference(
            stacks, rows, dummy, 1, 2 * v + 4, device), 3),
        # the kept rows read (no dummy row lands in shard 0), every row
        # written: table rows, degrees, k0, max_steps (and reset written)
        "bound_ms": ((b + per_new) * (v * w + v) * 4
                     + (2 * b + 3 * per_new) * 4) / HBM_BYTES_PER_S * 1e3,
        "library_ms": _cuda_ms(lambda: (
            torch.cat([s_[0] for s_ in stacks] + [dummy[None]]
                      ).index_select(0, src_l),
            torch.cat([s_[1] for s_ in stacks]
                      + [torch.zeros_like(stacks[0][1][:1])]
                      ).index_select(0, src_l)), 10),
        "shape": permute["shape"]}
    check(worst == 0, f"the mesh kernels at the serving class differ from "
          f"their plain versions by {worst}")
    partial = _mesh_partial_timing(held[f"4 slots, slices of {steps}"], cls,
                                   stages, device)
    rec = {"phase": "mesh_measure", "class": cls.name, "a0": a0,
           "max_abs_err": worst,
           "held": _held_record(held), "fold": fold,
           "carry_permute_mesh": permute, "inputs_resize_mesh": resize,
           "lane_reset_partial": partial["lane_reset"],
           "lane_finish_partial": partial["lane_finish"], "card": card}
    emit(rec)
    return rec


# the mesh runs of the drawn-once stream: (name, mesh slots on cuda:0 or
# None, mode, device carry); the unsharded run first and last
MESH_RUNS = (
    ("unsharded, continuous", None, "continuous", False),
    ("mesh 2, continuous", 2, "continuous", False),
    ("mesh 4, continuous", 4, "continuous", False),
    ("mesh 2, continuous, device carry", 2, "continuous", True),
    ("mesh 4, continuous, device carry", 4, "continuous", True),
    ("mesh 2, sync", 2, "sync", False),
    ("unsharded, continuous, again", None, "continuous", False),
)
MESH_MAIN = "mesh 4, continuous, device carry"


def _mesh_front(ref: dict, classes: dict, name: str, n, mode: str,
                carry: bool, device: str, ids=None, before=None) -> tuple:
    """The drawn-once stream (or its requests ``ids``) through a
    ``ServeFrontEnd`` at batch 8 over ``n`` lane slots on cuda:0, or one
    slot on each device of a list ``n`` (None: unsharded); every result
    equal to the single-graph loop's. ``before`` runs on the started front
    end first. Returns (record, front end)."""
    from dgc_tpu_torch.kernels import carry as kcar
    from dgc_tpu_torch.kernels import serve as ks
    from dgc_tpu_torch.serve.batched import lane_mesh_over
    from dgc_tpu_torch.serve.queue import ServeFrontEnd

    ids = list(ref["graphs"]) if ids is None else ids
    mesh = (None if n is None else lane_mesh_over(n) if isinstance(n, list)
            else _mesh_of(n, device))
    n = None if mesh is None else mesh.n
    ks.reset_launch_counts()
    kcar.reset_launch_counts()
    front = ServeFrontEnd(batch_max=8, workers=8, mode=mode,
                          queue_depth=max(64, 2 * len(ids)),
                          device_carry=carry, device=device,
                          mesh_devices=mesh).start()
    try:
        if before is not None:
            before(front)
        t = time.perf_counter()
        tickets = [front.submit(ref["graphs"][rid].arrays, request_id=rid)
                   for rid in ids]
        results = {str(x.request.request_id): x.result(timeout=900)
                   for x in tickets}
        wall = time.perf_counter() - t
    finally:
        front.shutdown()
    for d in ([device] if mesh is None else set(mesh.devices)):
        torch.cuda.synchronize(d)
    for rid, res in results.items():
        want, cls = ref["results"][rid], classes[rid]
        check(res.ok and res.minimal_colors == want["minimal_colors"]
              and list(res.attempts) == want["attempts"]
              and np.array_equal(res.colors, want["colors"])
              and res.batched == (cls is not None)
              and res.shape_class == (cls.name if cls else None),
              f"{name} {rid}: {res.status} {res.minimal_colors} "
              f"{res.attempts} vs {want['minimal_colors']} "
              f"{want['attempts']}")
    launches = dict(ks.launch_counts)
    carry_launches = dict(kcar.launch_counts)
    folds = ks.mesh_folds()
    sst = front.scheduler.stats_snapshot()
    supersteps = launches["lane_superstep"] / (n or 1)
    check(all(launches[k_] > 0 for k_ in _SERVE_KERNELS)
          and "lane_mesh_fold" not in launches
          and (folds > 0) == (n is not None),
          f"{name}: launches {launches}, folds {folds}")
    if n is not None:
        # every superstep: n × (K13, K15), the last K15 folding (K14 on
        # staged rungs)
        check(ks.partial_launch_counts["lane_finish"]
              == launches["lane_finish"], f"{name}: an unsharded K15 ran "
              f"{ks.partial_launch_counts}")
    mesh_carry = ("carry_permute_mesh", "inputs_resize_mesh")
    check(all((carry_launches[k_] > 0) == (carry and n is not None)
              for k_ in mesh_carry)
          and (carry_launches["lane_seat"] > 0) == carry,
          f"{name}: carry launches {carry_launches}")
    rec = {"phase": "mesh_main", "run": name, "mesh": n,
           "devices": None if mesh is None else [str(d) for d in
                                                  mesh.devices],
           "mode": mode, "mesh_folds": folds,
           "device_carry": carry, "requests": len(ids), "wall_s": wall,
           "graphs_per_s": len(ids) / wall, "slices": sst["slices"],
           "batches": sst["batches"], "launches": launches,
           "partial_launches": dict(ks.partial_launch_counts),
           "carry_launches": carry_launches,
           "launches_per_superstep": (sum(launches[k_] for k_ in (
               "lane_superstep", "lane_finish", "lane_compact"))
               / supersteps if supersteps else None),
           "mesh_snapshot": front.scheduler.mesh_snapshot(),
           "mesh_health": front.scheduler.mesh_health(),
           "h2d_mb": sst["h2d_bytes"] / 1e6, "d2h_mb": sst["d2h_bytes"] / 1e6}
    return rec, front


def phase_mesh_main(card: str, serve: dict, device: str = "cuda") -> dict:
    """``serve_main``'s stream, drawn once (``phase_serve_main``'s
    ``_serve_reference``), through the front end over 2 and 4 lane slots
    on cuda:0 (``lane_mesh_over``), continuous with the host mirror and
    the device carry, sync at 2, beside the unsharded run in the same
    call: every request equal to the single-graph loop's (so to the
    unsharded run's); the partial K15/K16 launched and folding on every
    mesh run, no standalone K26, the mesh K18/K19 on the device-carry ones.
    Then the failure-
    domain plane at 4 slots: ``mesh@3=device_loss:1`` degrades to 2
    (every request still equal), then ``mark_healthy`` and
    ``request_restore`` bring 4 back and the 20k requests run again. One
    card: the slots share cuda:0, so this measures what the mesh costs,
    not a gain. First ``--mesh-devices`` above the card count must exit 2;
    last ``measure_mesh``."""
    from dgc_tpu_torch.resilience import faults
    from dgc_tpu_torch.resilience.faults import FaultSchedule
    from dgc_tpu_torch.serve.cli import serve_main

    # more slots than the host has cards: a usage error, as in dgc_tpu
    with tempfile.TemporaryDirectory() as tmp:
        one = Path(tmp) / "one.jsonl"
        one.write_text(json.dumps(SERVE_STREAM[0]) + "\n")
        rc = serve_main(["--requests", str(one), "--mesh-devices",
                         str(2 * torch.cuda.device_count())])
    check(rc == 2, f"--mesh-devices above the card count: rc {rc}")
    ref, classes = serve["ref"], serve["classes"]
    runs = {}
    for name, n, mode, carry in MESH_RUNS:
        rec, _front = _mesh_front(ref, classes, name, n, mode, carry, device)
        rec["card"] = card
        emit(rec)
        runs[name] = rec
    plane = faults.FaultPlane(FaultSchedule.parse("mesh@3=device_loss:1"))
    with faults.injected(plane):
        rec, front = _mesh_front(ref, classes, "mesh 4, degrade", 4,
                                 "continuous", True, device)
    sched = front.scheduler
    stats = sched.stats_snapshot()
    check(bool(plane.fired_snapshot()) and sched.mesh_devices == 2
          and stats["mesh_degrades"] == 1,
          f"mesh degrade: {sched.mesh_health()}, {stats['mesh_degrades']}")
    rec.update(mesh_degrades=stats["mesh_degrades"],
               lanes_evacuated=stats["lanes_evacuated"], card=card)
    emit(rec)
    runs["mesh 4, degrade"] = rec

    def degrade_then_restore(front_):
        s_ = front_.scheduler
        with faults.injected(faults.FaultPlane(
                FaultSchedule.parse("mesh@1=device_loss:1"))):
            first = front_.submit(ref["graphs"]["u0"].arrays,
                                  request_id="u0").result(timeout=900)
        check(first.ok and s_.mesh_devices == 2, f"mesh restore: the "
              f"degrade left {s_.mesh_devices} slots")
        s_.device_health.mark_healthy(1)
        s_.request_restore()
        deadline = time.time() + 60
        while s_.mesh_devices != 4 and time.time() < deadline:
            time.sleep(0.01)
        check(s_.mesh_devices == 4, f"mesh restore: {s_.mesh_health()}")

    ids = [rid for rid in ref["graphs"] if rid.startswith("u")]
    rec, front = _mesh_front(ref, classes, "mesh 4, restore", 4,
                             "continuous", True, device, ids=ids,
                             before=degrade_then_restore)
    stats = front.scheduler.stats_snapshot()
    check(stats["mesh_restores"] == 1 and front.scheduler.mesh_devices == 4
          and not front.health()["mesh"]["degraded"],
          f"mesh restore: {front.scheduler.mesh_health()}")
    rec.update(mesh_restores=stats["mesh_restores"], card=card)
    emit(rec)
    runs["mesh 4, restore"] = rec
    return {"runs": runs, "measure": measure_mesh(
        card, [g for rid, g in ref["graphs"].items() if rid.startswith("u")],
        device)}


# the multi-card runs (``--mesh-cards``): (name, one slot a card or None,
# mode, device carry)
MESH_CARD_RUNS = (
    ("unsharded, continuous", None, "continuous", False),
    ("every card, continuous", True, "continuous", False),
    ("every card, continuous, device carry", True, "continuous", True),
    ("every card, sync", True, "sync", False),
)


def phase_mesh_cards(card: str, out_dir: Path) -> dict:
    """The lane mesh with one slot on each card of the host (peer access,
    the last shard's partial K15/K16 to finish folding in its tail, on
    whichever card, through the other cards' control blocks and the mesh
    ticket on cuda:0, the events that order each round and each resize's
    gathers across cards):
    the held mesh sweeps at the serving class with shard i on card i mod
    the count, then the drawn-once stream through the front end over
    every card, continuous with the host mirror and with the device
    carry, and sync, beside the unsharded run on cuda:0: every request
    equal to the single-graph loop's on cuda:0."""
    from dgc_tpu_torch.serve.shape_classes import DEFAULT_LADDER

    count = torch.cuda.device_count()
    check(count >= 2, f"--mesh-cards needs two cards or more, has {count}")
    cards = [torch.device("cuda", i) for i in range(count)]
    ref = _serve_reference(out_dir, "cuda")
    classes = {rid: DEFAULT_LADDER.class_for(g.num_vertices, g.max_degree)
               for rid, g in ref["graphs"].items()}
    _cls, _stages, _b, _steps, held = _held_mesh_sweeps(
        [g for rid, g in ref["graphs"].items() if rid.startswith("u")],
        lambda slots: [cards[i % count] for i in range(slots)])
    emit({"phase": "mesh_cards_held", "cards": count,
          "held": _held_record(held), "card": card})
    runs = {}
    for name, spread, mode, carry in MESH_CARD_RUNS:
        rec, _front = _mesh_front(ref, classes, name,
                                  cards if spread else None, mode, carry,
                                  "cuda")
        rec["card"] = card
        emit(rec)
        runs[name] = rec
    return runs


def mesh_kernels_line(mesh: dict, mesh_err: int) -> list[dict]:
    """The mesh instances of K18/K19 and the partial K16/K15 on the lane
    mesh's main path (``MESH_MAIN``: 4 slots, continuous, batch 8, the
    device carry; the other mesh runs' launches beside), times at the
    serving class (``measure_mesh``). K26 is no launch of its own: its fold
    is the partial K15/K16's tail, so their entries carry the folds the
    main path made (``mesh_folds``) and the partial K15's the fold's cost
    (``_fold_cost``)."""
    main = mesh["runs"][MESH_MAIN]
    meas = mesh["measure"]
    err = max(mesh_err, meas["max_abs_err"])
    rows = (("carry_permute_mesh", "dgc_tpu_torch/csrc/carry.cu",
             "dgc_tpu/serve/batched.py:892"),
            ("inputs_resize_mesh", "dgc_tpu_torch/csrc/carry.cu",
             "dgc_tpu/serve/batched.py:901"))
    out = []
    for name, source, replaces in rows:
        m = meas[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": main["carry_launches"][name],
                    "launches_other": {r: v["carry_launches"][name]
                                       for r, v in mesh["runs"].items()
                                       if v is not main and v["mesh"]},
                    "max_abs_err": err, "ms": m["ms"],
                    "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                    "bound_by": "bytes", "library_ms": m["library_ms"],
                    "shape": m["shape"]})
    for name in ("lane_reset", "lane_finish"):  # the partial K16/K15
        m = meas[f"{name}_partial"]
        entry = {"name": f"{name}_partial", "route": "cuda",
                 "source": "dgc_tpu_torch/csrc/serve.cu",
                 "replaces": "dgc_tpu/serve/batched.py:821",
                 "launches": main["partial_launches"][name],
                 "max_abs_err": err, "ms": m["ms"],
                 "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                 "bound_by": "bytes", "library_ms": None,
                 "shape": m["shape"], "mesh_folds": main["mesh_folds"],
                 "mesh_folds_other": {r: v["mesh_folds"]
                                      for r, v in mesh["runs"].items()
                                      if v is not main and v["mesh"]}}
        if name == "lane_finish":
            entry["fold"] = meas["fold"]
        out.append(entry)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mesh-cards", action="store_true",
                        help="run only the lane mesh across every card "
                             "(two or more)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from dgc_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is missing ({e})", file=sys.stderr)
        return 1
    card = card_line()
    t_total = t = time.perf_counter()
    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, together
        list(pool.map(build.build, sources))
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "nvcc": {k: v.strip().splitlines()[-8:]
                   for k, v in build.build_log.items()}})
    if args.mesh_cards:
        with tempfile.TemporaryDirectory() as tmp:
            phase_mesh_cards(card, Path(tmp))
        emit({"phase": "total", "seconds": time.perf_counter() - t_total})
        print(card_lines())
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    # the long chain's and the dense CLI's CPU references run in children
    # beside the card
    with tempfile.TemporaryDirectory() as tmp, ProcessPoolExecutor(
            2, mp_context=get_context("spawn")) as child:
        out_dir = Path(tmp)
        reference = child.submit(chain_reference)
        dense_cpu = child.submit(dense_cpu_reference,
                                 str(out_dir / "dense_cpu.json"))
        t = time.perf_counter()
        kernel_err = phase_kernels("cuda")
        compact_err = phase_compact_kernels("cuda")
        hub_err = phase_hub_kernels("cuda")
        block_err = phase_block_kernels("cuda")
        dense_err = phase_dense_kernels("cuda")
        tel_err = phase_telemetry_kernels("cuda")
        serve_err = phase_serve_kernels("cuda")
        carry_err = phase_carry_kernels("cuda")
        mesh_err = phase_mesh_kernels("cuda")
        emit({"phase": "kernels_vs_plain",
              "max_abs_err": max(kernel_err, compact_err, hub_err, block_err,
                                 dense_err, tel_err, serve_err, carry_err,
                                 mesh_err),
              "seconds": time.perf_counter() - t})

        t = time.perf_counter()
        rows = phase_engines("cuda") + phase_dense_engines("cuda")
        emit({"phase": "engines_vs_cpu", "runs": rows,
              "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        rows = phase_telemetry_engines("cuda")
        emit({"phase": "telemetry_engines_vs_cpu", "runs": rows,
              "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        rows = phase_serve_engines("cuda")
        emit({"phase": "serve_engines_vs_cpu", "runs": rows,
              "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        phase_carry_engines("cuda")
        phase_speculate_engines("cuda")
        emit({"phase": "carry_speculate_engines_vs_cpu",
              "seconds": time.perf_counter() - t})

        main_runs, blocked = phase_main_path(
            card, out_dir, MAIN_ARGS, ELL_BACKENDS,
            ((False, 1), (False, 4), (True, 1), (True, 4)))
        rmat_runs, blocked_rmat = phase_main_path(
            card, out_dir, RMAT_ARGS, ("ell-compact", "ell-bucketed"),
            ((False, 1), (False, 4)))
        blocked += blocked_rmat
        t = time.perf_counter()
        sharded = phase_sharded_main(card, out_dir, main_runs, rmat_runs)
        emit({"phase": "sharded_main_done",
              "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        ring = phase_ring_main(card, out_dir, main_runs, rmat_runs,
                               sharded.pop("graphs"))
        emit({"phase": "ring_main_done", "seconds": time.perf_counter() - t})
        telemetry = phase_telemetry_main(card, out_dir)
        dense_runs = phase_dense_main(card, out_dir, dense_cpu.result())
        t = time.perf_counter()
        serve = phase_serve_main(card, out_dir)
        emit({"phase": "serve_main_done", "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        mesh = phase_mesh_main(card, serve)
        emit({"phase": "mesh_main_done", "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        spec = phase_speculate_main(card, out_dir)
        carry = measure_carry(card)
        emit({"phase": "speculate_main_done",
              "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        rows = phase_block_engines("cuda", reference.result())
        emit({"phase": "block_engines_vs_cpu", "runs": rows,
              "seconds": time.perf_counter() - t})
    emit({"phase": "total", "seconds": time.perf_counter() - t_total})
    print(card)
    line = kernels_line(main_runs, rmat_runs, blocked, kernel_err,
                        compact_err, hub_err, block_err)
    for entry in line:  # the sharded-bucketed sweeps' launches of K5, K7, K8
        if entry["name"] in ("segmented_superstep", "hub_slots",
                             "hub_superstep"):
            entry["launches_sharded"] = {
                k: r["launches"][entry["name"]]
                for k, r in sharded["runs"].items()}
    emit({"kernels": line
          + dense_kernels_line(dense_runs, dense_err)
          + telemetry_kernels_line(main_runs, rmat_runs, blocked, telemetry,
                                   tel_err)
          + serve_kernels_line(serve, serve_err)
          + carry_kernels_line(serve, spec, carry, carry_err, serve_err)
          + shard_kernels_line(sharded)
          + ring_kernels_line(ring)
          + mesh_kernels_line(mesh, mesh_err)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def kernels_line(main_runs: dict, rmat_runs: dict, blocked: list,
                 kernel_err: int, compact_err: int, hub_err: int,
                 block_err: int) -> list[dict]:
    """Every kernel of the port: its launches on its main path, its time,
    plain time, bound and library time at that path's shapes. K3-K6 are
    read on the 1M uniform path (``launches_rmat`` beside), K7 and K8 on
    the 1M RMAT path, K9 and K10 on the 1M uniform jump sweep at A = 4
    (the strict one's and RMAT's launches beside)."""
    compact, bucketed = main_runs["ell-compact"], main_runs["ell-bucketed"]
    hub = rmat_runs["ell-compact"]
    k1k2 = "dgc_tpu_torch/csrc/superstep.cu"
    k3k6 = "dgc_tpu_torch/csrc/compact.cu"
    k7k8 = "dgc_tpu_torch/csrc/hub.cu"
    full = compact["stages"][0]
    first = next(r for r in compact["stages"] if r["pad"] is not None)
    compact_err = max(compact_err, compact["max_abs_err"], hub["max_abs_err"])
    hub_err = max(hub_err, hub["max_abs_err"])

    def by_backend(name):
        return {b: r["launches"][name] for b, r in main_runs.items()}

    def rmat(name):
        return hub["launches"][name]

    k9k10 = "dgc_tpu_torch/csrc/block.cu"
    jump4 = next(r for r in blocked if not r["strict"]
                 and r["attempts_per_dispatch"] > 1)
    others = {f"{'strict' if r['strict'] else 'jump'} {r['gen']}": r
              for r in blocked
              if r["attempts_per_dispatch"] > 1 and r is not jump4}
    block_err = max([block_err] + [r["max_abs_err"] for r in blocked
                                   if "max_abs_err" in r])

    return [
        {"name": "superstep_rows", "route": "cuda", "source": k1k2,
         "replaces": "dgc_tpu/ops/speculative.py:124",
         "launches": bucketed["launches"]["superstep_rows"],
         "launches_by_backend": by_backend("superstep_rows"),
         "max_abs_err": max(
             [kernel_err, rmat_runs["ell-bucketed"]["max_abs_err"],
              rmat_runs["ell-bucketed"]["k1_sweep_held_err"]]
             + [r["max_abs_err"] for b, r in main_runs.items()
                if b != "ell-compact"]),
         "ms": bucketed["k1_ms"], "plain_ms": bucketed["k1_plain_ms"],
         "bound_ms": bucketed["k1_bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "ell": {key: main_runs["ell"][f"k1_{key}"]
                 for key in ("ms", "plain_ms", "bound_ms")},
         "by_bucket": bucketed["k1_by_bucket"],
         "rmat_bucketed": {
             "launches": rmat_runs["ell-bucketed"]["launches"][
                 "superstep_rows"],
             **{key: rmat_runs["ell-bucketed"][key] for key in (
                 "k1_ms", "k1_plain_ms", "k1_bound_ms", "k1_by_bucket",
                 "k1_sweep_ms", "k1_sweep_launches", "k1_sweep_bound_ms",
                 "k1_sweep_plain_ms", "k1_sweep_max_launch_ms")}}},
        {"name": "superstep_finish", "route": "cuda", "source": k1k2,
         "replaces": "dgc_tpu/engine/bucketed.py:273",
         "launches": bucketed["launches"]["superstep_finish"],
         "launches_by_backend": by_backend("superstep_finish"),
         "max_abs_err": kernel_err,
         "ms": bucketed["k2_ms"], "plain_ms": bucketed["k2_plain_ms"],
         "bound_ms": bucketed["k2_bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "compact_slots", "route": "cuda", "source": k3k6,
         "replaces": "dgc_tpu/engine/compact.py:288",
         "launches": compact["launches"]["compact_slots"],
         "launches_rmat": rmat("compact_slots"),
         "max_abs_err": compact_err, "ms": first["k3_ms"],
         "plain_ms": first["k3_plain_ms"], "bound_ms": first["k3_bound_ms"],
         "bound_by": "bytes", "library_ms": first["k3_library_ms"],
         "replays_held": first["k3_replays_held"]},
        {"name": "stage_rows", "route": "cuda", "source": k3k6,
         "replaces": "dgc_tpu/engine/compact.py:1526",
         "launches": compact["launches"]["stage_rows"],
         "launches_rmat": rmat("stage_rows"),
         "max_abs_err": compact_err, "ms": first["k4_ms"],
         "plain_ms": first["k4_plain_ms"], "bound_ms": first["k4_bound_ms"],
         "bound_by": "bytes", "library_ms": first["k4_library_ms"]},
        {"name": "segmented_superstep", "route": "cuda", "source": k3k6,
         "replaces": "dgc_tpu/ops/segmented_gather.py:237",
         "launches": compact["launches"]["segmented_superstep"],
         "launches_rmat": rmat("segmented_superstep"),
         "max_abs_err": compact_err, "ms": full["k5_ms"],
         "plain_ms": full["k5_plain_ms"], "bound_ms": full["k5_bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "stage_finish", "route": "cuda", "source": k3k6,
         "replaces": "dgc_tpu/engine/compact.py:1048",
         "launches": compact["launches"]["stage_finish"],
         "launches_rmat": rmat("stage_finish"),
         "max_abs_err": compact_err, "ms": full["k6_push_ms"],
         "plain_ms": full["k6_plain_ms"], "bound_ms": full["k6_push_bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "hub_slots", "route": "cuda", "source": k7k8,
         "replaces": "dgc_tpu/engine/compact.py:713",
         "launches": rmat("hub_slots"), "max_abs_err": hub_err,
         "ms": hub["k7_ms"], "plain_ms": hub["k7_plain_ms"],
         "bound_ms": hub["k7_bound_ms"], "bound_by": "bytes",
         "library_ms": hub["k7_library_ms"]},
        {"name": "hub_superstep", "route": "cuda", "source": k7k8,
         "replaces": "dgc_tpu/engine/compact.py:1074",
         "launches": rmat("hub_superstep"), "max_abs_err": hub_err,
         "ms": hub["k8_ms"], "plain_ms": hub["k8_plain_ms"],
         "bound_ms": hub["k8_bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "block_record", "route": "cuda", "source": k9k10,
         "replaces": "dgc_tpu/engine/compact.py:1799",
         "launches": jump4["launches"]["block_record"],
         "launches_other": {n: r["launches"]["block_record"]
                            for n, r in others.items()},
         "max_abs_err": block_err, "ms": jump4["k9_ms"],
         "plain_ms": jump4["k9_plain_ms"], "bound_ms": jump4["k9_bound_ms"],
         "bound_by": "bytes", "library_ms": jump4["k9_library_ms"]},
        {"name": "block_start", "route": "cuda", "source": k9k10,
         "replaces": "dgc_tpu/engine/compact.py:1784",
         "launches": jump4["launches"]["block_start"],
         "launches_other": {n: r["launches"]["block_start"]
                            for n, r in others.items()},
         "max_abs_err": block_err, "ms": jump4["k10_ms"],
         "plain_ms": jump4["k10_plain_ms"],
         "bound_ms": jump4["k10_bound_ms"], "bound_by": "bytes",
         "library_ms": jump4["k10_library_ms"]},
    ]



def telemetry_kernels_line(main_runs: dict, rmat_runs: dict, blocked: list,
                           telemetry: dict, tel_err: int) -> list[dict]:
    """The recording variants (B11): launches on the telemetry runs of
    their paths (``phase_telemetry_main``); K2 timed on the 1M uniform
    bucketed shapes, K5 and K6 on the 1M uniform full-table superstep's
    inputs, K8 the mean over the 1M RMAT recording sweep's launches, K9
    and K10 on one held block of the 1M uniform jump sweep. ``off_ms`` is
    the kernel without recording on the same inputs, timed in the same
    run; ``sweep_mean_ms`` the per-launch means over a whole sweep, off
    and on."""
    bucketed = main_runs["ell-bucketed"]
    compact, hub = main_runs["ell-compact"], rmat_runs["ell-compact"]
    full = compact["stages"][0]
    jump4 = next(r for r in blocked if not r["strict"]
                 and r["attempts_per_dispatch"] > 1)
    err = max([tel_err, compact["max_abs_err_rec"], hub["max_abs_err_rec"]])

    def launches(run, name):
        return telemetry[run]["launches"][name]

    def sweep_means(name):
        return {g: [r["per_launch_ms"][name], r["per_launch_rec_ms"][name]]
                for g, r in (("uniform", compact), ("rmat", hub))
                if name in r["per_launch_ms"]}

    nh = hub["hub_buckets"]
    k8_bytes = hub["bytes_per_launch"]["hub_superstep"] + 4 * nh
    base = {"route": "cuda", "max_abs_err": err, "bound_by": "bytes"}
    return [
        {**base, "name": "superstep_finish_rec",
         "source": "dgc_tpu_torch/csrc/superstep.cu",
         "replaces": "dgc_tpu/obs/kernel.py:95",
         "launches": launches("uniform ell-bucketed", "superstep_finish_rec"),
         "ms": bucketed["k2_rec_ms"], "plain_ms": bucketed["k2_rec_plain_ms"],
         "bound_ms": bucketed["k2_rec_bound_ms"], "library_ms": None,
         "off_ms": bucketed["k2_fold_ms"]},
        {**base, "name": "segmented_superstep_rec",
         "source": "dgc_tpu_torch/csrc/compact.cu",
         "replaces": "dgc_tpu/ops/segmented_gather.py:203",
         "launches": launches("uniform jump", "segmented_superstep_rec"),
         "launches_other": {n: r["launches"]["segmented_superstep_rec"]
                            for n, r in telemetry.items()},
         "ms": full["k5_rec_ms"], "plain_ms": full["k5_rec_plain_ms"],
         "bound_ms": full["k5_rec_bound_ms"], "library_ms": None,
         "off_ms": full["k5_ms"],
         "sweep_mean_ms": sweep_means("segmented_superstep")},
        {**base, "name": "stage_finish_rec",
         "source": "dgc_tpu_torch/csrc/compact.cu",
         "replaces": "dgc_tpu/obs/kernel.py:95",
         "launches": launches("uniform jump", "stage_finish_rec"),
         "launches_other": {n: r["launches"]["stage_finish_rec"]
                            for n, r in telemetry.items()},
         "ms": full["k6_rec_ms"], "plain_ms": full["k6_rec_plain_ms"],
         "bound_ms": full["k6_rec_bound_ms"], "library_ms": None,
         "off_ms": full["k6_ms"], "row_bytes": full["k6_row_bytes"],
         "sweep_mean_ms": sweep_means("stage_finish")},
        {**base, "name": "hub_superstep_rec",
         "source": "dgc_tpu_torch/csrc/hub.cu",
         "replaces": "dgc_tpu/engine/compact.py:257",
         "launches": launches("rmat jump", "hub_superstep_rec"),
         "ms": hub["per_launch_rec_ms"]["hub_superstep"],
         "plain_ms": hub["plain_rec_ms_by_kernel"]["hub_superstep"],
         "bound_ms": k8_bytes / HBM_BYTES_PER_S * 1e3, "library_ms": None,
         "off_ms": hub["per_launch_ms"]["hub_superstep"]},
        {**base, "name": "block_record_rec",
         "source": "dgc_tpu_torch/csrc/block.cu",
         "replaces": "dgc_tpu/engine/compact.py:1806",
         "launches": launches("uniform strict A=4", "block_record_rec"),
         "ms": jump4["k9_rec_ms"], "plain_ms": jump4["k9_rec_plain_ms"],
         "bound_ms": jump4["k9_rec_bound_ms"],
         "library_ms": jump4["k9_rec_library_ms"], "off_ms": jump4["k9_ms"]},
        {**base, "name": "block_start_rec",
         "source": "dgc_tpu_torch/csrc/block.cu",
         "replaces": "dgc_tpu/engine/compact.py:1770",
         "launches": launches("uniform strict A=4", "block_start_rec"),
         "ms": jump4["k10_rec_ms"], "plain_ms": jump4["k10_rec_plain_ms"],
         "bound_ms": jump4["k10_rec_bound_ms"],
         "library_ms": jump4["k10_rec_library_ms"], "off_ms": jump4["k10_ms"]},
    ]


def dense_kernels_line(dense_runs: dict, dense_err: int) -> list[dict]:
    """K11 and K12 read on the 16,384-vertex RMAT dense path (kmax 2,432),
    the uniform path's numbers beside."""
    rmat, uniform = dense_runs["rmat"], dense_runs["fast"]
    source = "dgc_tpu_torch/csrc/dense.cu"
    err = max(dense_err, rmat["max_abs_err"], uniform["max_abs_err"])

    def beside(name):
        return {key: uniform[f"{name}_{key}"]
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")
                if f"{name}_{key}" in uniform}

    return [
        {"name": "dense_forbid", "route": "cuda", "source": source,
         "replaces": "dgc_tpu/engine/dense_engine.py:44",
         "launches": rmat["launches"]["dense_forbid"],
         "launches_uniform": uniform["launches"]["dense_forbid"],
         "max_abs_err": err, "ms": rmat["k11_ms"],
         "plain_ms": rmat["k11_plain_ms"], "bound_ms": rmat["k11_bound_ms"],
         "bound_by": rmat["k11_bound_by"],
         "library_ms": rmat["k11_library_ms"], "uniform": beside("k11")},
        {"name": "dense_resolve", "route": "cuda", "source": source,
         "replaces": "dgc_tpu/engine/dense_engine.py:44",
         "launches": rmat["launches"]["dense_resolve"],
         "launches_uniform": uniform["launches"]["dense_resolve"],
         "max_abs_err": err, "ms": rmat["k12_ms"],
         "plain_ms": rmat["k12_plain_ms"], "bound_ms": rmat["k12_bound_ms"],
         "bound_by": "bytes", "library_ms": None, "uniform": beside("k12")},
    ]


if __name__ == "__main__":
    sys.exit(main())
