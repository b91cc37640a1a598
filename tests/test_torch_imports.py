"""The port stands alone: importing every module of ``repro_torch`` loads
no JAX and nothing of the JAX package."""
import json
import os
import subprocess
import sys

import pytest

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "src")

# one fresh process imports every module in turn and notes, for each, the
# JAX or JAX-package modules that its import loaded first
_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch


def bad():
    return {m for m in sys.modules
            if m == "jax" or m.startswith(("jax.", "jaxlib"))
            or m == "repro" or m.startswith("repro.")}


names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
loaded = {}
for name in names:
    before = bad()
    importlib.import_module(name)
    loaded[name] = sorted(bad() - before)
print(json.dumps({"names": names, "loaded": loaded, "bad": sorted(bad())}))
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, text=True,
                         capture_output=True, timeout=120, check=True).stdout
    return json.loads(out)


def test_port_imports_no_jax_and_no_reference_package(probe):
    assert len(probe["names"]) >= 80
    bad = ",".join(probe["bad"])
    assert bad == "", f"the port loaded {bad}"


_LIVE_MODULES = ("core.epoch", "core.repair", "core.invariants",
                 "serving.scrub", "serving.scheduler", "serving.async_engine",
                 "resilience.errors", "resilience.validate",
                 "resilience.degrade", "launch.serve", "launch.build_index")


@pytest.mark.parametrize("name", _LIVE_MODULES)
def test_live_mutation_module_imports_alone(probe, name):
    """Each module of live mutation and the async engine is among the
    probe's imports, and its import loaded no JAX and nothing of the JAX
    package (the copies of the JAX package's JAX-free modules included)."""
    full = "repro_torch." + name
    assert full in probe["names"]
    assert probe["loaded"][full] == [], \
        f"{full} loaded {probe['loaded'][full]}"


_SHARDING_MODULES = ("distributed.collectives", "distributed.index",
                      "launch.mesh", "launch.ranks", "persist.sharded",
                      "core.metrics", "models.embedding_bag")


@pytest.mark.parametrize("name", _SHARDING_MODULES)
def test_sharding_module_imports_alone(probe, name):
    """Each module of the sharded path is among the probe's imports and
    loaded no JAX and nothing of the JAX package."""
    full = "repro_torch." + name
    assert full in probe["names"]
    assert probe["loaded"][full] == [], \
        f"{full} loaded {probe['loaded'][full]}"


_CELL_MODULES = ("distributed.sharding", "launch.cells")


@pytest.mark.parametrize("name", _CELL_MODULES)
def test_cell_module_imports_alone(probe, name):
    """The placement rules and the cell builder are among the probe's
    imports and loaded no JAX and nothing of the JAX package."""
    full = "repro_torch." + name
    assert full in probe["names"]
    assert probe["loaded"][full] == [], \
        f"{full} loaded {probe['loaded'][full]}"


def test_cells_test_helper_loads_no_jax():
    """``tests/_torch_cells.py`` loads JAX only in its subprocess."""
    tests = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys, _torch_cells; print(json.dumps(sorted(m for m "
            "in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'jaxlib')) or m == 'repro' or m.startswith('repro.'))))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([_SRC, tests]))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120, check=True).stdout
    assert json.loads(out) == []


def test_dist_test_helper_loads_no_jax():
    """The torch side of ``tests/_torch_dist.py`` (its rank functions run
    in every spawned rank) loads no JAX: only its JAX subprocess does."""
    tests = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys, _torch_dist; print(json.dumps(sorted(m for m "
            "in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'jaxlib')) or m == 'repro' or m.startswith('repro.'))))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([_SRC, tests]))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120, check=True).stdout
    assert json.loads(out) == []


def test_chip_smoke_imports_no_jax():
    root = os.path.dirname(_SRC)
    with open(os.path.join(root, "chip_smoke.py")) as f:
        src = f.read()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            mod = words[1]
            assert not (mod == "jax" or mod.startswith(("jax.", "repro.")) or
                        mod == "repro"), line
