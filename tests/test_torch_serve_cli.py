"""``python -m dgc_tpu_torch serve --requests ... --device cpu`` against
``python -m dgc_tpu.cli serve`` on the same request file: per request the
status, minimal color count, ``batched``, ``shape_class`` and the coloring
file's bytes are equal, in continuous and sync mode; ``--device-carry``
and ``--speculate-k 2`` give the port's own results without them. A bad
request file, a flag the port does not have yet, a bad ``--speculate-k``
and ``--device cuda`` without a card each exit with code 2.
"""

import filecmp
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module: str, args, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, "serve", *args],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def _requests(path):
    lines = [{"id": i, "node_count": 80 + 30 * i, "max_degree": 6, "seed": i}
             for i in range(3)]
    lines.append({"id": "rmat", "node_count": 300, "max_degree": 12,
                  "seed": 9, "gen_method": "rmat"})
    path.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return path


@pytest.fixture(scope="module")
def request_file(tmp_path_factory):
    return _requests(tmp_path_factory.mktemp("serve") / "requests.jsonl")


def _results(path) -> dict:
    return {str(r["id"]): r for r in
            (json.loads(x) for x in path.read_text().splitlines())}


@pytest.mark.parametrize("mode", ("continuous", "sync"))
def test_serve_cli_equals_dgc_tpu(request_file, tmp_path, mode):
    out = {}
    for name, module, extra in (
            ("port", "dgc_tpu_torch", ["--device", "cpu", "--log-json",
                                       str(tmp_path / "run.jsonl"),
                                       "--run-manifest",
                                       str(tmp_path / "manifest.json"),
                                       "--metrics-prom",
                                       str(tmp_path / "metrics.prom")]),
            ("jax", "dgc_tpu.cli", [])):
        r = _run(module, ["--requests", str(request_file),
                          "--results", str(tmp_path / f"{name}.jsonl"),
                          "--output-colorings", str(tmp_path / name),
                          "--batch-max", "2", "--window-ms", "20",
                          "--serve-mode", mode, *extra])
        assert r.returncode == 0, r.stderr[-2000:]
        out[name] = _results(tmp_path / f"{name}.jsonl")
    assert sorted(out["port"]) == sorted(out["jax"]) == ["0", "1", "2", "rmat"]
    for rid, got in out["port"].items():
        want = out["jax"][rid]
        for key in ("status", "minimal_colors", "batched", "shape_class",
                    "error"):
            assert got[key] == want[key], (rid, key)
        assert filecmp.cmp(got["coloring"], want["coloring"], shallow=False)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from validate_runlog import validate_file

    assert validate_file(str(tmp_path / "run.jsonl")) == []
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["serve"]["summary"]["completed"] == 4
    assert "dgc_serve_requests_total" in (tmp_path / "metrics.prom").read_text()


def _port(request_file, d, name: str, flags) -> dict:
    r = _run("dgc_tpu_torch", ["--requests", str(request_file),
                               "--results", str(d / f"{name}.jsonl"),
                               "--output-colorings", str(d / name),
                               "--log-json", str(d / f"{name}.log"),
                               "--batch-max", "2", "--window-ms", "20",
                               "--device", "cpu", *flags])
    assert r.returncode == 0, r.stderr[-2000:]
    return _results(d / f"{name}.jsonl")


@pytest.fixture(scope="module")
def plain_port(request_file, tmp_path_factory):
    """The port's continuous run without the two flags."""
    return _port(request_file, tmp_path_factory.mktemp("plain"), "plain", [])


@pytest.mark.parametrize("flags", (["--device-carry"], ["--speculate-k", "2"],
                                   ["--device-carry", "--speculate-k",
                                    "auto"]),
                         ids=("device_carry", "speculate", "both"))
def test_serve_cli_device_carry_and_speculation(request_file, plain_port,
                                                tmp_path, flags):
    """The flags run with rc 0 and every request equals the run without
    them. Serve requests are jump-mode sweeps (the fused pair), where
    speculation is inert: ``--speculate-k`` seats no speculative lane
    here, so the speculate cases show that the flag parses, reaches
    ``serve_start`` and changes no result. The speculation plane itself
    is tested in ``test_torch_speculate.py``."""
    out = {"plain": plain_port, "flags": _port(request_file, tmp_path,
                                               "flags", flags)}
    assert sorted(out["plain"]) == sorted(out["flags"])
    for rid, got in out["flags"].items():
        want = out["plain"][rid]
        for key in ("status", "minimal_colors", "batched", "shape_class"):
            assert got[key] == want[key], (rid, key)
        assert filecmp.cmp(got["coloring"], want["coloring"], shallow=False)
    events = [json.loads(x) for x in
              (tmp_path / "flags.log").read_text().splitlines()]
    start = next(e for e in events if e["event"] == "serve_start")
    assert start["device_carry"] == ("--device-carry" in flags)
    assert ("speculate_k" in start) == ("--speculate-k" in flags)
    kinds = {e["event"] for e in events}
    assert "serve_slice" in kinds and "spec_seated" not in kinds


def test_serve_cli_bad_speculate_k(request_file):
    r = _run("dgc_tpu_torch", ["--requests", str(request_file), "--device",
                               "cpu", "--speculate-k", "none"])
    assert r.returncode == 2
    assert "--speculate-k must be a positive integer" in r.stderr


def test_serve_cli_bad_request_file(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{not json\n")
    r = _run("dgc_tpu_torch", ["--requests", str(bad), "--device", "cpu"])
    assert r.returncode == 2
    assert "bad request" in r.stderr
    r = _run("dgc_tpu_torch", ["--requests", str(tmp_path / "missing.jsonl"),
                               "--device", "cpu"])
    assert r.returncode == 2


@pytest.mark.parametrize("flag", (["--listen", "8080"], ["--result-cache"],
                                  ["--inject-faults", "x"], ["--replicas",
                                                             "2"]))
def test_serve_cli_refuses_unported_flags(request_file, flag):
    r = _run("dgc_tpu_torch", ["--requests", str(request_file), "--device",
                               "cpu", *flag])
    assert r.returncode == 2
    assert "not yet ported" in r.stderr
    assert flag[0].split("=")[0] in r.stderr


def test_serve_cli_without_a_card_exits_2(request_file):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    r = _run("dgc_tpu_torch", ["--requests", str(request_file)])
    assert r.returncode == 2
    assert "no CUDA device" in r.stderr
