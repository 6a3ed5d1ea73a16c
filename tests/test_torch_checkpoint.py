"""The port's checkpoint/resume (``dgc_tpu_torch.utils.checkpoint``) keeps
``dgc_tpu``'s format and resumes exactly, on the CPU.

- A blocked sweep killed at a block boundary (an ``on_block`` that
  raises) resumes from its checkpoint to the uninterrupted result; so
  does a sequential one killed after an attempt.
- A directory written by ``dgc_tpu.utils.checkpoint.CheckpointManager``
  resumes in the port (sequential and blocked) as it resumes in
  ``dgc_tpu``, and one the port wrote restores in ``dgc_tpu``;
  ``graph_fingerprint`` strings are equal.
- ``WriteBehindCheckpointManager`` lands the newest snapshot, flushes on
  restore and close, writes the synchronous manager's bytes, and refuses a
  save once closed; a torn or foreign checkpoint is ignored.
- The CLI with ``--checkpoint-dir`` (and ``--checkpoint-write-behind``)
  writes the JAX CLI's coloring, and a completed checkpoint
  short-circuits a second run to the same output.
"""

import functools
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from dgc_tpu.engine.compact import CompactFrontierEngine as JaxCompact  # noqa: E402
from dgc_tpu.engine.minimal_k import find_minimal_coloring as jax_find  # noqa: E402
from dgc_tpu.models.generators import generate_random_graph_fast  # noqa: E402
from dgc_tpu.utils import checkpoint as jck  # noqa: E402
from dgc_tpu_torch import cli as tcli  # noqa: E402
from dgc_tpu_torch import convert  # noqa: E402
from dgc_tpu_torch.engine.base import AttemptResult, AttemptStatus  # noqa: E402
from dgc_tpu_torch.engine.compact import CompactFrontierEngine  # noqa: E402
from dgc_tpu_torch.engine.minimal_k import find_minimal_coloring  # noqa: E402
from dgc_tpu_torch.utils import checkpoint as ck  # noqa: E402

G = generate_random_graph_fast(400, avg_degree=6.0, seed=3)
TG = convert.graph_from_numpy(G.indptr, G.indices)
K0 = G.max_degree + 1


class Kill(Exception):
    pass


def rows(attempts) -> list:
    return [(a.k, int(a.status), a.supersteps, a.colors_used)
            for a in attempts]


def port_run(strict=True, attempts=1, checkpoint=None, on_block=None,
             on_attempt=None):
    return find_minimal_coloring(
        CompactFrontierEngine(TG, device="cpu"), K0, strict_decrement=strict,
        checkpoint=checkpoint, attempts_per_dispatch=attempts,
        on_block=on_block, on_attempt=on_attempt)


@functools.cache
def want():
    """The uninterrupted strict sweep."""
    return port_run()


def test_blocked_kill_at_a_block_boundary_resumes_exactly(tmp_path):
    blocks, pre = [], []

    def killer(k, attempts):
        if len(blocks) == 2:
            raise Kill
        blocks.append(k)

    with pytest.raises(Kill):
        port_run(attempts=3, checkpoint=ck.CheckpointManager(tmp_path),
                 on_block=killer, on_attempt=lambda r, v: pre.append(r))
    assert len(pre) == 6  # two blocks of three
    post = port_run(attempts=3, checkpoint=ck.CheckpointManager(tmp_path))
    assert rows(pre) + rows(post.attempts[1:]) == rows(want().attempts)
    np.testing.assert_array_equal(post.colors, want().colors)
    assert post.minimal_colors == want().minimal_colors
    # a completed checkpoint short-circuits: no attempt runs again
    again = port_run(attempts=3, checkpoint=ck.CheckpointManager(tmp_path))
    assert len(again.attempts) == 1
    np.testing.assert_array_equal(again.colors, want().colors)


@pytest.mark.parametrize("attempts", [1, 3])
def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, attempts):
    fp = jck.graph_fingerprint(G, "ell-compact", True)
    assert ck.graph_fingerprint(TG, "ell-compact", True) == fp
    assert ck.graph_fingerprint(TG, "ell-compact", False) != fp
    seen = []

    def kill_after_four(res, val):
        seen.append(res)
        if len(seen) == 4:
            raise Kill

    written = tmp_path / "jax"
    with pytest.raises(Kill):
        jax_find(JaxCompact(G), K0, strict_decrement=True,
                 on_attempt=kill_after_four,
                 checkpoint=jck.CheckpointManager(written, fingerprint=fp))
    shutil.copytree(written, tmp_path / "copy")
    ref = jax_find(JaxCompact(G), K0, strict_decrement=True,
                   checkpoint=jck.CheckpointManager(written, fingerprint=fp),
                   attempts_per_dispatch=attempts)
    ours = port_run(attempts=attempts, checkpoint=ck.CheckpointManager(
        tmp_path / "copy", fingerprint=fp))
    assert rows(ours.attempts) == rows(ref.attempts)
    np.testing.assert_array_equal(ours.colors, ref.colors)
    np.testing.assert_array_equal(ours.colors, want().colors)
    # the port's finished checkpoint restores in dgc_tpu, and back
    for restored in (jck.CheckpointManager(tmp_path / "copy",
                                           fingerprint=fp).restore(),
                     ck.CheckpointManager(written, fingerprint=fp).restore()):
        k, best, done = restored
        assert done and (k, best.k, int(best.status), best.supersteps) == \
            (ours.attempts[-1].k, want().attempts[-2].k, 1,
             want().attempts[-2].supersteps)
        np.testing.assert_array_equal(best.colors, want().attempts[-2].colors)
    # another graph's or mode's checkpoint is not this run's
    assert ck.CheckpointManager(written, fingerprint="other").restore() is None


def test_write_behind_lands_the_synchronous_bytes(tmp_path):
    best = AttemptResult(AttemptStatus.SUCCESS,
                         np.arange(50, dtype=np.int32) % 7, 12, 9)
    sync = ck.CheckpointManager(tmp_path / "sync", fingerprint="fp")
    wb = ck.WriteBehindCheckpointManager(tmp_path / "wb", fingerprint="fp")
    for m in (sync, wb):
        m.save(k=10, best=None, failed=False)
        m.save(k=8, best=best, failed=False)
    colors = best.colors.copy()
    best.colors[:] = -5  # the write-behind copy was taken at save()
    wb.flush()
    for name in ("sweep_state.json", "best_colors.npy"):
        assert (tmp_path / "wb" / name).read_bytes() == \
            (tmp_path / "sync" / name).read_bytes()
    k, got, done = wb.restore()
    assert (k, got.k, got.supersteps, done) == (8, 9, 12, False)
    np.testing.assert_array_equal(got.colors, colors)
    wb.save(k=7, best=None, failed=True)
    wb.close()
    wb.close()  # idempotent
    assert ck.CheckpointManager(tmp_path / "wb",
                                fingerprint="fp").restore()[::2] == (7, True)
    with pytest.raises(RuntimeError):
        wb.save(k=6, best=None, failed=True)
    wb.clear()
    assert wb.restore() is None


def test_a_torn_checkpoint_is_ignored(tmp_path, capsys):
    m = ck.CheckpointManager(tmp_path, fingerprint="fp")
    m.save(k=5, best=AttemptResult(AttemptStatus.SUCCESS,
                                   np.zeros(9, np.int32), 3, 6), failed=False)
    (tmp_path / "best_colors.npy").write_bytes(b"torn")
    assert m.restore() is None
    assert "checksum mismatch" in capsys.readouterr().err
    (tmp_path / "sweep_state.json").write_text("{not json")
    assert m.restore() is None
    assert "unreadable manifest" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [[], ["--checkpoint-write-behind"]],
                         ids=["sync", "write-behind"])
def test_cli_checkpoint_dir_writes_the_jax_cli_coloring(tmp_path, capsys,
                                                        extra):
    from dgc_tpu import cli as jcli

    common = ["--node-count", "150", "--max-degree", "9", "--seed", "7",
              "--strict-decrement", "--attempts-per-dispatch", "2", *extra]
    assert jcli.main(common + ["--checkpoint-dir", str(tmp_path / "jck"),
                               "--output-coloring",
                               str(tmp_path / "jax.json")]) == 0
    printed = []
    for out in ("port.json", "again.json"):  # the second run resumes done
        assert tcli.main(common + ["--device", "cpu", "--checkpoint-dir",
                                   str(tmp_path / "ck"), "--output-coloring",
                                   str(tmp_path / out)]) == 0
        assert (tmp_path / out).read_bytes() == \
            (tmp_path / "jax.json").read_bytes()
        printed.append(capsys.readouterr().out.count("attempt:"))
    assert printed[0] > 2 and printed[1] == 0
    for name in ("sweep_state.json", "best_colors.npy"):
        assert (tmp_path / "ck" / name).read_bytes() == \
            (tmp_path / "jck" / name).read_bytes()
