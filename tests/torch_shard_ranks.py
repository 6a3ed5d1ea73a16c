"""A group of gloo ranks for the sharded engines' multi-rank tests.

``RankGroup(n)`` starts ``n`` worker processes of this file once (a
module fixture holds it), each initialized the way ``torchrun`` would
leave it: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` in
its environment, read by ``dgc_tpu_torch.parallel.multihost.
initialize_multihost``. Each worker runs on one intra-op and one inter-op
thread, so the group does not load the test runner's cores. ``run(case)``
sends one case to every rank and returns their results in rank order:

- ``{"kind": "engine", "backend": ..., "graph": path of an .npz with
  indptr and indices, "kw": engine kwargs, "calls": [["attempt", k] |
  ["sweep", k0], ...]}`` → per call, ``(status, supersteps, k, colors)``
  (a sweep: the pair, the second None when no confirm ran); with
  ``"trajectory": true`` each result also ends in its trajectory's
  columns, and with ``"tensor_rows": true`` the list ends in the longest
  axis of any tensor the engine holds;
- ``{"kind": "cli", "argv": [...]}`` → ``(rc, stdout, stderr)`` of
  ``dgc_tpu_torch.cli.main``, every ``{rank}`` in the argv replaced by the
  rank (each rank its own output paths); an exception ends it with rc 1
  and its last line on stderr, as ``python -m`` would.

Nothing here imports JAX or ``dgc_tpu``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import select
import socket
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASE_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankGroup:
    def __init__(self, n: int = 2):
        self.n = n
        self.tmp = tempfile.TemporaryDirectory(prefix="dgc_ranks_")
        self.dir = Path(self.tmp.name)
        self.count = 0
        port = _free_port()
        self.procs = []
        for rank in range(n):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=str(ROOT))
            self.procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), str(self.dir)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                env=env, cwd=ROOT))
        for rank in range(self.n):
            self._reply(rank)  # each rank reports once its group is up

    def _reply(self, rank: int) -> dict:
        proc = self.procs[rank]
        ready, _, _ = select.select([proc.stdout], [], [], CASE_TIMEOUT_S)
        if not ready:  # a rank stuck in a collective its peer left
            for p in self.procs:
                p.kill()
            raise RuntimeError(f"rank {rank}: no reply in {CASE_TIMEOUT_S} s")
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"rank {rank} exited "
                               f"(rc {self.procs[rank].poll()})")
        return json.loads(line)

    def run(self, case: dict) -> list:
        self.count += 1
        case = dict(case, id=self.count)
        for p in self.procs:
            p.stdin.write(json.dumps(case) + "\n")
            p.stdin.flush()
        out = []
        for rank in range(self.n):
            reply = self._reply(rank)
            if "error" in reply:
                raise RuntimeError(f"rank {rank}: {reply['error']}")
            path = self.dir / f"result-{self.count}-{rank}.pkl"
            out.append(pickle.loads(path.read_bytes()))
        return out

    def close(self) -> None:
        for p in self.procs:
            try:
                p.stdin.close()
                p.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                p.kill()
        self.tmp.cleanup()


def _result(res):
    if res is None:
        return None
    return (int(res.status), int(res.supersteps), int(res.k), res.colors)


def _engine_case(case: dict):
    import numpy as np

    from dgc_tpu_torch.convert import graph_from_numpy

    g = np.load(case["graph"])
    arrays = graph_from_numpy(g["indptr"], g["indices"])
    if case["backend"] == "sharded":
        from dgc_tpu_torch.engine.sharded import ShardedELLEngine as Engine
    elif case["backend"] == "sharded-ring":
        from dgc_tpu_torch.engine.ring import RingHaloEngine as Engine
    else:
        from dgc_tpu_torch.engine.sharded_bucketed import \
            ShardedBucketedEngine as Engine
    eng = Engine(arrays, device="cpu", **case.get("kw", {}))
    eng.record_trajectory = bool(case.get("trajectory"))
    out = []
    for name, k in case["calls"]:
        if name == "attempt":
            res = eng.attempt(k)
            out.append(_result(res) + _traj(res))
        else:
            pair = eng.sweep(k)
            out.append(tuple(None if r is None else _result(r) + _traj(r)
                             for r in pair))
    if case.get("tensor_rows"):  # the longest axis of any engine tensor
        out.append(max(max(t.shape, default=1) for t in _tensors(eng)))
    return out


def _traj(res) -> tuple:
    """The trajectory's columns, when one was recorded."""
    t = res.trajectory
    if t is None:
        return ()
    return ((t.first_step, t.truncated)
            + tuple(getattr(t, c) for c in ("active", "fail", "mc",
                                             "gather_calls", "max_unconf")),)


def _tensors(obj):
    """Every tensor an engine holds, in attributes and nested tuples."""
    import torch

    stack = list(vars(obj).values())
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (tuple, list)):
            stack.extend(x)


def _cli_case(case: dict, rank: int):
    from dgc_tpu_torch import cli

    argv = [a.replace("{rank}", str(rank)) for a in case["argv"]]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            rc = e.code
        except Exception as e:  # as `python -m` ends on an uncaught one
            print(f"{type(e).__name__}: {e}", file=sys.stderr)
            rc = 1
    return rc, out.getvalue(), err.getvalue()


def _serve(work: Path) -> None:
    import torch

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    from dgc_tpu_torch.parallel.multihost import initialize_multihost

    assert initialize_multihost("cpu")
    rank = int(os.environ["RANK"])
    print(json.dumps({"up": rank}), flush=True)
    for line in sys.stdin:
        case = json.loads(line)
        try:
            res = (_engine_case(case) if case["kind"] == "engine"
                   else _cli_case(case, rank))
            (work / f"result-{case['id']}-{rank}.pkl").write_bytes(
                pickle.dumps(res))
            print(json.dumps({"id": case["id"]}), flush=True)
        except Exception:  # reported to the test, which fails on it
            print(json.dumps({"id": case["id"],
                              "error": traceback.format_exc()}), flush=True)


if __name__ == "__main__":
    _serve(Path(sys.argv[1]))
