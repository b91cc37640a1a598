"""The port stands alone: importing every module of ``repro_torch`` loads
no JAX and nothing of the JAX package."""
import os
import subprocess
import sys

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "src")

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names))
print(",".join(bad))
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, text=True,
                         capture_output=True, timeout=120, check=True).stdout
    n_modules, _, bad = out.partition("\n")
    assert int(n_modules) >= 60
    bad = bad.strip()
    assert bad == "", f"the port loaded {bad}"


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
