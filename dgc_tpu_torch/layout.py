"""The port's copy of the layout constants of ``dgc_tpu.layout`` that it
needs: the serve tier's per-lane carry (its slots, the result span and the
slots a slice may bring home) and its lane mesh's axis, the in-kernel telemetry's trajectory row
columns, the fill of an unwritten row, the clock mask, the attempt
block's trajectory slot, and the sharded flat pipeline's carry.
``tests/test_torch_telemetry.py`` and ``tests/test_torch_import.py`` hold
each equal to the original."""

# -- serve slice carry (serve.batched, one tensor per slot, lane-leading) --
#
# (phase, k, packed, step, prev_active, stall,   -- live sweep state
#  p1, s1, st1, used, p2, s2, st2,               -- jump-pair result slots
#  t_us, t_prev,                                 -- in-kernel timing slots
#  rung, nc, idx_rung, idx,                      -- frontier-ladder stage state
#  spec)                                         -- speculation tag
CARRY_PHASE = 0        # 0 first attempt, 1 confirm, >=2 done/idle
CARRY_K = 1            # live color budget
CARRY_PACKED = 2       # packed per-vertex color/freshness state
CARRY_STEP = 3         # superstep counter within the attempt
CARRY_PREV_ACTIVE = 4  # previous superstep's active count (stall window)
CARRY_STALL = 5        # stall counter
CARRY_P1 = 6           # result slot 1: packed colors
CARRY_S1 = 7           # result slot 1: supersteps
CARRY_ST1 = 8          # result slot 1: status
CARRY_USED = 9         # colors used by attempt 1 (confirm budget source)
CARRY_P2 = 10          # result slot 2: packed colors
CARRY_S2 = 11          # result slot 2: supersteps
CARRY_ST2 = 12         # result slot 2: status
T_US = 13              # accumulated live superstep wall-µs (timing mode)
T_PREV = 14            # last in-kernel clock sample (timing mode)
CARRY_RUNG = 15        # compaction-stage ladder rung the lane has reached
CARRY_NC = 16          # lane's live frontier after its last superstep
CARRY_IDX_RUNG = 17    # rung the lane's compacted slot list was built at
CARRY_IDX = 18         # compacted slot list (int32[A0]; dummy = V_pad)
CARRY_SPEC = 19        # speculation tag (1: an attempt-only lane, no confirm)
CARRY_LEN = 20

OUT0 = 6               # first result slot (== CARRY_P1)
N_OUT = 7              # result slots p1..st2

# the carry slots a slice may bring home when the carry stays on the card:
# the phase/rung/nc scheduling scalars, the timing slot, and the result
# span [OUT0, OUT0+N_OUT)
D2H_SLOTS = (0, 13, 15, 16, 6, 7, 8, 9, 10, 11, 12)

# -- serve lane-mesh sharding (serve.batched sharded section) --------------
#
# The lane-sharded serve tier splits every batch-leading buffer (the carry
# slots above, the input stacks, the scheduling and speculation vectors)
# over a one-axis mesh of shard slots, axis LANES_AXIS, in contiguous
# blocks; the executed rung and the live word stay global (the fold in the
# partial K15/K16's tail, K26, makes them so).
LANES_AXIS = 0         # the axis every serve buffer shards on
MESH_AXIS = "lanes"    # the serve mesh's single axis name

# -- trajectory buffer row (obs.kernel, one column per metric) ------------
COL_ACTIVE = 0         # global active count after the superstep
COL_FAIL = 1           # failure-predicate flag
COL_MC = 2             # divergence candidate (max forbidden-set fill)
COL_GATHER_CALLS = 3   # neighbor-state element-gather call count
COL_MAX_UNCONF = 4     # max unconfirmed-neighbor count over gathered rows
COL_TS_US = 5          # in-kernel clock timestamp (obs.devclock)
TRAJ_COLS = 6          # fixed columns before the bucket-active tail

# unwritten-row / not-recorded fill
TRAJ_FILL = -1

# 31-bit µs mask (obs.devclock): clock samples stay non-negative in int32,
# so they never collide with the TRAJ_FILL sentinel
US_MASK = 0x7FFFFFFF

# the attempt block's stacked per-attempt trajectory buffers
# int32[A, cap, C] (dgc_tpu.layout's block-output slot of the same name)
BK_TRAJ = 11

# -- sharded flat-pipeline carry (dgc_tpu.engine.sharded `_flat_pipeline`) --
#
# (packed_l, step, status, prev_active, stall,   -- live sweep state
#  rec...,                                       -- prefix-resume ring (5)
#  traj)                                         -- trajectory buffer
# These ids are the reference's carry layout, kept for parity: no port code
# indexes a tuple by them. The port's shard loop (engine.fused) keeps the
# same state on each rank in other places: the carry tensor ``packed_l``,
# the scalars in its control block (kernels.shard's ``SC_*`` slots), the
# ring in shard_rec_empty's triple with its count and best candidate in
# the control block, the trajectory in its own buffer.
SH_PACKED = 0
SH_STEP = 1
SH_STATUS = 2
SH_PREV_ACTIVE = 3
SH_STALL = 4
SH_REC0 = 5            # first prefix-resume ring slot
SH_N_REC = 5           # ring slots (engine.fused.shard_rec_empty layout)
SH_TRAJ = 10           # trajectory buffer rides last
SH_CARRY_LEN = 11
