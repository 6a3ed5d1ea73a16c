"""The port (``dgc_tpu_torch``) and ``chip_smoke.py`` import neither JAX
nor anything of ``dgc_tpu``; the host modules the port copies verbatim
are byte-equal to their originals.

The import check runs in a subprocess: this test process already holds
``jax`` (``tests/conftest.py`` imports it).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dgc_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "dgc_tpu"}
# the package's modules; the git-ignored build directory holds no source
SOURCES = sorted(p for p in PORT.rglob("*.py")
                 if "_build" not in p.relative_to(PORT).parts) + [ROOT / "chip_smoke.py"]


def _module_name(path: Path) -> str:
    parts = path.relative_to(ROOT).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def test_importing_every_module_leaves_jax_and_dgc_tpu_out():
    modules = [_module_name(p) for p in SOURCES]
    code = (
        "import importlib, json, sys\n"
        "for m in json.loads(sys.argv[1]):\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(modules)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert "dgc_tpu_torch.kernels.superstep" in modules
    assert "dgc_tpu_torch.native.bindings" in modules


def test_native_paths_build_from_the_ports_own_source():
    from dgc_tpu_torch.native import bindings

    assert bindings.SRC == PORT / "native" / "graphgen.cpp"
    assert bindings.BUILD_DIR == PORT / "_build"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_or_dgc_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    named = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            named.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            named.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            named.add(str(node.args[0].value).split(".")[0])
    assert not named & FORBIDDEN, named & FORBIDDEN


# the port's verbatim copies of dgc_tpu's JAX-free host modules
VERBATIM = ("obs/events.py", "obs/schema.py", "obs/manifest.py",
            "obs/instrument.py", "obs/trace.py")


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_equal_their_originals(rel):
    assert (PORT / rel).read_bytes() == (ROOT / "dgc_tpu" / rel).read_bytes()


# the port's copies that differ from their original by the package name
# alone: ``dgc_tpu_torch`` where the original imports ``dgc_tpu`` (the
# checkpoint module of faults.py, the driver of supervisor.py, the
# classifier of domains.py, the engine, models and ops of
# shape_classes.py, the scheduler, batched epilogue and pricing model of
# speculate.py); no other difference
RENAMED = ("resilience/faults.py", "resilience/retry.py",
           "resilience/supervisor.py", "resilience/domains.py",
           "serve/shape_classes.py", "serve/speculate.py")


@pytest.mark.parametrize("rel", RENAMED)
def test_renamed_copies_equal_their_originals(rel):
    copy = (PORT / rel).read_text()
    original = (ROOT / "dgc_tpu" / rel).read_text()
    assert "dgc_tpu_torch" not in original
    assert "dgc_tpu_torch" in copy
    assert copy.replace("dgc_tpu_torch", "dgc_tpu") == original


def _literals(path: Path) -> dict:
    tree = ast.parse(path.read_text())
    return {t.id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) for t in node.targets
            if isinstance(t, ast.Name)}


SERVE_LAYOUT = ("CARRY_PHASE", "CARRY_K", "CARRY_PACKED", "CARRY_STEP",
                "CARRY_PREV_ACTIVE", "CARRY_STALL", "CARRY_P1", "CARRY_S1",
                "CARRY_ST1", "CARRY_USED", "CARRY_P2", "CARRY_S2",
                "CARRY_ST2", "T_US", "T_PREV", "CARRY_RUNG", "CARRY_NC",
                "CARRY_IDX_RUNG", "CARRY_IDX", "CARRY_SPEC", "CARRY_LEN",
                "OUT0", "N_OUT", "D2H_SLOTS")


def test_serve_carry_layout_equals_the_original():
    port = _literals(PORT / "layout.py")
    original = _literals(ROOT / "dgc_tpu" / "layout.py")
    for name in SERVE_LAYOUT:
        assert port[name] == original[name], name
    # every slot named once, in order
    assert sorted(port[n] for n in SERVE_LAYOUT[:20]) == list(range(20))


SHARD_LAYOUT = ("SH_PACKED", "SH_STEP", "SH_STATUS", "SH_PREV_ACTIVE",
                "SH_STALL", "SH_REC0", "SH_N_REC", "SH_TRAJ", "SH_CARRY_LEN")


def test_sharded_carry_layout_equals_the_original():
    port = _literals(PORT / "layout.py")
    original = _literals(ROOT / "dgc_tpu" / "layout.py")
    for name in SHARD_LAYOUT:
        assert port[name] == original[name], name


# functions (and classes) the port copies verbatim into a module of its own
VERBATIM_FUNCTIONS = (
    ("utils/schedule_model.py", "strict_survival_curve"),
    ("utils/schedule_model.py", "speculation_auto_cap"),
    ("engine/sharded_bucketed.py", "ShardedBucketLayout"),
    ("engine/sharded_bucketed.py", "build_sharded_buckets"),
    ("engine/sharded_bucketed.py", "shard_prune_cfg"),
    ("engine/sharded_bucketed.py", "shard_pad_for"),
    ("parallel/mesh.py", "pad_to_multiple"),
    ("engine/ring.py", "build_rotation_tables"),
    ("engine/ring.py", "flat_rotation_entries"),
)


def _function_source(path: Path, name: str) -> str:
    text = path.read_text()
    for node in ast.parse(text).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name == name:
            return ast.get_source_segment(text, node)
    raise AssertionError(f"{path} has no function {name}")


@pytest.mark.parametrize("rel,name", VERBATIM_FUNCTIONS,
                         ids=[n for _r, n in VERBATIM_FUNCTIONS])
def test_verbatim_functions_equal_their_originals(rel, name):
    assert _function_source(PORT / rel, name) == \
        _function_source(ROOT / "dgc_tpu" / rel, name)


# functions the port copies with the package name alone changed
# (``dgc_tpu_torch`` where the original imports from ``dgc_tpu``)
RENAMED_FUNCTIONS = (
    ("engine/ring.py", "build_bucketed_rotation_tables"),
)


@pytest.mark.parametrize("rel,name", RENAMED_FUNCTIONS,
                         ids=[n for _r, n in RENAMED_FUNCTIONS])
def test_renamed_functions_equal_their_originals(rel, name):
    copy = _function_source(PORT / rel, name)
    original = _function_source(ROOT / "dgc_tpu" / rel, name)
    assert "dgc_tpu_torch" not in original
    assert "dgc_tpu_torch" in copy
    assert copy.replace("dgc_tpu_torch", "dgc_tpu") == original


# functions the port copies with one expression changed: (file, name, the
# original's text, the port's)
ADAPTED_FUNCTIONS = (
    # the default canary runs on the device the scheduler put the slot on
    # (a lane mesh may repeat a card), not on the host's i-th device
    ("resilience/probe.py", "HealthProbe", "else canary_probe)           #",
     "else slot_canary(scheduler))  #"),
)


@pytest.mark.parametrize("rel,name,was,now", ADAPTED_FUNCTIONS,
                         ids=[a[1] for a in ADAPTED_FUNCTIONS])
def test_adapted_functions_equal_their_originals(rel, name, was, now):
    copy = _function_source(PORT / rel, name)
    original = _function_source(ROOT / "dgc_tpu" / rel, name)
    assert original.count(was) == 1 and copy.count(now) == 1
    assert copy.replace(now, was) == original
