"""The port's copy of the layout constants of ``dgc_tpu.layout`` that the
in-kernel telemetry needs: the trajectory row's columns, the fill of an
unwritten row, the clock mask, and the attempt block's trajectory slot.
``tests/test_torch_telemetry.py`` holds each equal to the original."""

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
