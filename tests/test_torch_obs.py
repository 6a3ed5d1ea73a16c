"""The port's CLI telemetry (``--log-json``, ``--run-manifest``,
``--metrics-prom``, ``--superstep-timing``) on the CPU against a
``dgc_tpu.cli`` run on the same graph and flags.

- The JSONL passes the JAX package's own checkers
  (``tools/validate_runlog.py``, ``dgc_tpu.obs.schema``) and holds the
  same events in the same order.
- The manifest loads with ``dgc_tpu.obs.manifest.load_manifest``, renders
  with ``tools/report_run.py`` and holds the same slots, attempts and
  trajectories (timing fields by presence only).
- The Prometheus file holds the same metric families, and the counters
  that do not measure time (``dgc_device_dispatches_total`` — one per
  engine call, an attempt block once — the calls, attempts and
  supersteps, the final color count) hold the same values.
- Trajectories and timestamps follow the flags as in ``dgc_tpu.cli``:
  the manifest or the metrics file switches them on, timing needs one of
  them and applies to ``ell-compact`` only.

Every file goes under the test's temporary directory.
"""

import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from dgc_tpu import cli as jcli  # noqa: E402
from dgc_tpu.obs.manifest import load_manifest  # noqa: E402
from dgc_tpu.obs.schema import validate_record  # noqa: E402
from dgc_tpu_torch import cli as tcli  # noqa: E402

TOOLS = Path(__file__).resolve().parent.parent / "tools"
GRAPH = ["--node-count", "300", "--max-degree", "8", "--seed", "11"]
ALL_FLAGS = ("log", "manifest", "prom", "timing")
RUNS = {
    "jump": (GRAPH, ALL_FLAGS),
    "strict-block": (GRAPH + ["--strict-decrement",
                              "--attempts-per-dispatch", "4"], ALL_FLAGS),
    "bucketed": (GRAPH + ["--backend", "ell-bucketed"], ALL_FLAGS),
    "no-timing": (GRAPH, ("log", "manifest", "prom")),
    "prom-only": (GRAPH + ["--backend", "ell"], ("log", "prom", "timing")),
    "log-only": (GRAPH, ("log", "timing")),
    "dense": (GRAPH + ["--backend", "dense"], ALL_FLAGS),
}
_done: dict = {}


def _argv(d: Path, extra, flags) -> list:
    argv = list(extra) + ["--output-coloring", str(d / "colors.json")]
    for flag, opt, name in (("log", "--log-json", "run.jsonl"),
                            ("manifest", "--run-manifest", "manifest.json"),
                            ("prom", "--metrics-prom", "metrics.prom")):
        if flag in flags:
            argv += [opt, str(d / name)]
    if "timing" in flags:
        argv.append("--superstep-timing")
    return argv


def run_pair(name: str, tmp_path_factory) -> tuple:
    """(jax dir, port dir) of the run ``name``, made once per module."""
    if name not in _done:
        extra, flags = RUNS[name]
        out = []
        for main, more in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
            d = tmp_path_factory.mktemp(name)
            assert main(_argv(d, list(extra) + more, flags)) == 0
            out.append(d)
        _done[name] = tuple(out)
    return _done[name]


def _events(d: Path) -> list:
    return [json.loads(line) for line in (d / "run.jsonl").read_text()
            .splitlines()]


def _prom(d: Path) -> tuple:
    """(families, samples) of a Prometheus text file."""
    fams, samples = set(), {}
    for line in (d / "metrics.prom").read_text().splitlines():
        if line.startswith("# TYPE"):
            fams.add(tuple(line.split()[2:4]))
        elif line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            samples[key] = float(value)
    return fams, samples


def _kinds(events: list) -> list:
    """The event kinds in order, one ``device_memory`` per run of them
    (one event per device: the tests' JAX platform has eight)."""
    out = []
    for e in events:
        if not (e["event"] == "device_memory" and out
                and out[-1] == "device_memory"):
            out.append(e["event"])
    return out


def _untimed(traj: dict) -> dict:
    return {k: v for k, v in traj.items() if k != "step_us"}


@pytest.mark.parametrize("name", list(RUNS))
def test_event_stream_is_schema_clean_and_matches_jax(name, tmp_path_factory,
                                                      capsys):
    jd, td = run_pair(name, tmp_path_factory)
    capsys.readouterr()
    sys.path.insert(0, str(TOOLS))
    from validate_runlog import validate_file

    assert validate_file(str(td / "run.jsonl")) == []
    ours, ref = _events(td), _events(jd)
    for rec in ours:
        assert validate_record(rec) == [], rec
    assert _kinds(ours) == _kinds(ref)
    for kind in ("attempt", "trajectory", "sweep_start", "graph_generated",
                 "post_reduce"):
        a = [e for e in ours if e["event"] == kind]
        b = [e for e in ref if e["event"] == kind]
        strip = ("t", "step_us", "time_s")
        assert [{k: v for k, v in e.items() if k not in strip} for e in a] \
            == [{k: v for k, v in e.items() if k not in strip} for e in b]
        for x, y in zip(a, b):
            assert ("step_us" in x) == ("step_us" in y)
    # the colorings are the JAX CLI's
    assert (td / "colors.json").read_bytes() == \
        (jd / "colors.json").read_bytes()


@pytest.mark.parametrize("name", [n for n, (_, f) in RUNS.items()
                                  if "manifest" in f])
def test_manifest_matches_jax(name, tmp_path_factory, capsys):
    jd, td = run_pair(name, tmp_path_factory)
    ours = load_manifest(str(td / "manifest.json"))
    ref = load_manifest(str(jd / "manifest.json"))
    assert sorted(ours) == sorted(ref)
    for slot in ("graph", "sweep", "tuning", "distributed", "aborts",
                 "resilience"):
        assert ours[slot] == ref[slot], slot
    assert set(ours["devices"]) == set(ref["devices"])
    assert sorted(ours["phases"]["totals"]) == sorted(ref["phases"]["totals"])
    assert len(ours["attempts"]) == len(ref["attempts"]) >= 2
    for a, b in zip(ours["attempts"], ref["attempts"]):
        assert {k: v for k, v in a.items() if k != "trajectory"} == \
            {k: v for k, v in b.items() if k != "trajectory"}
        assert (a["trajectory"] is None) == (b["trajectory"] is None)
        if a["trajectory"] is not None:
            assert _untimed(a["trajectory"]) == _untimed(b["trajectory"])
            assert ("step_us" in a["trajectory"]) == \
                ("step_us" in b["trajectory"])
    assert {k: v for k, v in ours["result"].items() if k != "wall_time_s"} \
        == {k: v for k, v in ref["result"].items() if k != "wall_time_s"}
    sys.path.insert(0, str(TOOLS))
    import report_run

    capsys.readouterr()
    assert report_run.main([str(td / "manifest.json")]) == 0
    assert "attempt" in capsys.readouterr().out


@pytest.mark.parametrize("name", [n for n, (_, f) in RUNS.items()
                                  if "prom" in f])
def test_prometheus_families_and_counts_match_jax(name, tmp_path_factory):
    jd, td = run_pair(name, tmp_path_factory)
    (fams, ours), (ref_fams, ref) = _prom(td), _prom(jd)
    assert fams == ref_fams
    counts = [k for k in ref if k.split("{")[0] in (
        "dgc_device_dispatches_total", "dgc_engine_calls_total",
        "dgc_attempts_total", "dgc_supersteps_total", "dgc_last_attempt_k",
        "dgc_minimal_colors") or k.endswith("_count")]
    assert "dgc_device_dispatches_total" in counts
    assert {k: ours.get(k) for k in counts} == {k: ref[k] for k in counts}


def test_telemetry_follows_the_flags_as_in_jax(tmp_path_factory):
    """Trajectories need the manifest or the metrics file; timing also
    needs one of them and applies to ``ell-compact`` only; the blocked
    run counts one dispatch per block."""
    def trajs(name):
        jd, td = run_pair(name, tmp_path_factory)
        return [[e for e in _events(d) if e["event"] == "trajectory"]
                for d in (td, jd)]

    for name in ("jump", "strict-block"):
        for t in trajs(name):
            assert t and all("step_us" in e for e in t)
    for name in ("no-timing", "bucketed", "prom-only"):
        for t in trajs(name):
            assert t and not any("step_us" in e for e in t)
    for name in ("log-only", "dense"):
        assert trajs(name) == [[], []]
    _, td = run_pair("strict-block", tmp_path_factory)
    blocks = [e for e in _events(td) if e["event"] == "attempt_block"]
    attempts = [e for e in _events(td) if e["event"] == "attempt"]
    assert len(attempts) > len(blocks) >= 2
    assert _prom(td)[1]["dgc_device_dispatches_total"] == len(blocks)
