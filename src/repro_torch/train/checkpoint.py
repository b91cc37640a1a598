"""Step-atomic checkpointing, ported from ``src/repro/train/checkpoint.py``
with its on-disk format kept byte for byte, so a checkpoint either
package writes restores in the other.

Layout (one directory per step):

    <dir>/step_000000123.tmp/     # written first
        manifest.json             # step, mesh_shape, extra, leaves
        arr_00000.npy ...         # one file per leaf
    <dir>/step_000000123/         # atomic rename when complete
    <dir>/LATEST                  # text file with the newest complete step

Crash-consistency: a half-written checkpoint never becomes visible because
the rename is the commit point; ``restore_latest`` only ever sees complete
directories.  Leaf keys are the state's dict keys joined by ``/``, in the
JAX package's sorted-key flatten order (``train/tree.py``).  bfloat16 (and
float8) leaves are saved as unsigned views of their bits under the dtype's
name; the reader maps them back to torch's types itself, since numpy has
no such types without ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train import tree as T

_SEP = "/"
_UINT_FOR_SIZE = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
# a numpy view that torch.from_numpy takes, for a bits type's item size
_NP_BITS = {1: np.uint8, 2: np.int16}
# numpy has no counterpart of these torch types: saved as bits, by name
_BITS_DTYPES = {"bfloat16": torch.bfloat16}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _BITS_DTYPES[_name] = getattr(torch, _name)
_BITS_NAMES = {v: k for k, v in _BITS_DTYPES.items()}


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array to save and the dtype name to record."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _BITS_NAMES.get(t.dtype)
        if name is not None:
            size = t.element_size()
            bits = torch.uint8 if size == 1 else torch.int16
            arr = t.view(bits).numpy().view(_UINT_FOR_SIZE[size])
            return arr, name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    want = _BITS_DTYPES.get(dtype_name)
    if want is not None:
        return torch.from_numpy(arr.view(_NP_BITS[arr.dtype.itemsize])
                                ).view(want)
    if arr.dtype != np.dtype(dtype_name):
        arr = arr.view(np.dtype(dtype_name))
    return torch.from_numpy(arr)


def _flatten(tree) -> list[tuple[str, Any]]:
    return [(T.key_of(path, _SEP), leaf)
            for path, leaf in T.leaves_with_path(tree)]


def save(directory: str, step: int, state: Any, *,
         mesh_shape: Optional[tuple] = None, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(state)
    manifest = {"step": step, "mesh_shape": mesh_shape, "extra": extra or {},
                "leaves": []}
    for i, (key, leaf) in enumerate(flat):
        arr, dtype_name = _to_numpy(leaf)
        fn = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"key": key, "file": fn, "shape": list(arr.shape),
             "dtype": dtype_name})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # commit point
    latest = os.path.join(directory, "LATEST")
    with open(latest + ".tmp", "w") as f:
        f.write(name)
    os.replace(latest + ".tmp", latest)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    for d in os.listdir(directory):           # orphaned partial writes
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[1])


def restore(directory: str, step: int, like: Any, *,
            device=None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (a tree of tensors, or of
    anything with a ``shape``).  Each leaf keeps its saved type and lands
    on ``device``, or else on the device of ``like``'s leaf at its path
    (the CPU for a leaf that is no tensor)."""
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {l["key"]: l for l in manifest["leaves"]}
    leaves = []
    for key, leaf in _flatten(like):
        entry = by_key.get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(path, entry["file"]))
        want = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: saved {arr.shape} != expected {want}")
        dev = device if device is not None else getattr(leaf, "device",
                                                        "cpu")
        leaves.append(_from_numpy(arr, entry["dtype"]).to(dev))
    return T.unflatten(like, leaves), manifest


def restore_latest(directory: str, like: Any, *, device=None):
    step = latest_step(directory)
    if step is None:
        return None, None
    return restore(directory, step, like, device=device)
