"""The JAX side of ``tests/test_torch_sharding.py`` and
``tests/test_torch_cells.py``, and the lists of what they compare.

``python tests/_torch_cells.py CASE OUT.json`` runs one case's JAX
programs in a process of its own and writes, as JSON, what they return:

* ``sharding``: every placement rule of ``repro.distributed.sharding``
  for every arch of the registry, on the ``(2, 2)``, ``(16, 16)`` and
  ``(2, 16, 16)`` meshes, as ``{path: spec}`` leaf lists.  The rules run
  on ``jax.sharding.AbstractMesh``es, but ``egnn_batch_specs``, which
  reads ``mesh.devices``, runs on a mesh of forced host devices (512).
* ``cells``: ``repro.launch.cells.build_cell`` on the ``(2, 2)`` debug
  mesh (8 forced host devices) for every cell of :data:`CELLS`: the
  arguments' shapes and dtypes, the specs, ``donate``, ``kind`` and
  ``meta`` (``cfg`` aside), or the ``SkippedCell`` reason; and
  ``VARIANTS``' names.

:func:`start` runs it as a subprocess; :func:`wait` reads the JSON.
Only the JAX side imports JAX: importing this module loads neither JAX
nor the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

TIMEOUT_S = 240.0
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DEVICES = {"sharding": 512, "cells": 8}
DEG_SHAPES = ("search_16m", "explore_16m", "build_wave_16m")
LM_TRAIN_VARIANTS = ("seqpar", "microbatch4", "seqpar+microbatch4")
GNN_VARIANTS = ("bf16msgs", "nodeshard", "bf16msgs+nodeshard", "halo")
DEG_VARIANTS = ("bf16vecs", "bf16vecs+topk")


def cells(registry: list, kinds: dict) -> list:
    """(arch, shape, variant) of every cell compared: each cell of
    ``registry`` ((arch, shape) pairs) and of ``deg-ann``, and each variant
    where it applies (``kinds[(arch, shape)]`` is the cell's kind):
    seqpar / microbatch4 on the LM train cells, seqpar on prefill, the
    EGNN variants on the full-graph and minibatch cells, bf16vecs on the
    DEG cells."""
    out = [(a, s, "") for a, s in registry]
    out += [("deg-ann", s, "") for s in DEG_SHAPES]
    for a, s in registry:
        kind = kinds[(a, s)]
        if kind == "train":
            out += [(a, s, v) for v in LM_TRAIN_VARIANTS]
        elif kind == "prefill":
            out.append((a, s, "seqpar"))
        elif kind in ("full_graph", "minibatch"):
            out += [(a, s, v) for v in GNN_VARIANTS]
    out += [("deg-ann", s, v) for s in DEG_SHAPES for v in DEG_VARIANTS]
    return out


def cell_id(arch: str, shape: str, variant: str) -> str:
    return f"{arch}/{shape}/{variant}"


def start(case: str, out: str) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        f"--xla_force_host_platform_device_count={DEVICES[case]}"))
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             case, out], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait(proc: subprocess.Popen, out: str) -> dict:
    try:
        log, _ = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX side exited {proc.returncode}:\n{log}")
    with open(out) as f:
        return json.load(f)


def spec_json(spec) -> list:
    """A spec as JSON: per dim None, a name, or a list of names."""
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _specs(tree) -> dict:
    import jax
    from jax.sharding import PartitionSpec as P

    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(_key(k) for k in path): spec_json(s) for path, s in flat}


def _abstract(tree) -> dict:
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key(k) for k in path): [list(x.shape), str(x.dtype)]
            for path, x in flat}


def _jax_sharding() -> dict:
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import all_cells, get_arch
    from repro.distributed import sharding as SH
    from repro.models import egnn as E
    from repro.models import recsys as R
    from repro.models import transformer as T
    from repro.train.optimizer import adamw, partitioned, sgd

    out = {}
    archs = sorted({a for a, _ in all_cells()})
    for name, (shape, axes) in MESHES.items():
        mesh = AbstractMesh(shape, axes)
        dev_mesh = jax.make_mesh(shape, axes)
        res = {"dp_axes": spec_json([SH.dp_axes(mesh)])}
        for arch in archs:
            spec = get_arch(arch)
            if spec.family == "lm":
                cfg = spec.model
                p = SH.lm_param_specs(cfg, mesh)
                res[f"{arch}/params"] = _specs(p)
                res[f"{arch}/batch"] = _specs(SH.lm_batch_specs(mesh))
                st = jax.eval_shape(adamw(1e-4).init, T.abstract_params(cfg))
                res[f"{arch}/opt"] = _specs(SH.opt_state_specs(p, st))
                for c in spec.shapes:
                    res[f"{arch}/{c.name}/cache"] = _specs(
                        SH.lm_cache_specs(cfg, mesh, c["global_batch"]))
            elif spec.family == "gnn":
                for c in spec.shapes:
                    cfg = spec.model_for(c.name)
                    res[f"{arch}/{c.name}/params"] = _specs(
                        SH.egnn_param_specs(E.abstract_params(cfg)))
                    res[f"{arch}/{c.name}/batch"] = _specs(
                        SH.egnn_batch_specs(dev_mesh, c.kind, c.dims))
            else:
                cfg = spec.model
                p = SH.recsys_param_specs(cfg, mesh)
                res[f"{arch}/params"] = _specs(p)
                lab = lambda path, leaf: (  # noqa: E731
                    "embed" if path and getattr(path[0], "key", None)
                    in ("table", "fm_w") else "dense")
                opt = partitioned(lab, {"embed": sgd(0.05),
                                        "dense": adamw(1e-3)})
                st = jax.eval_shape(opt.init, R.abstract_params(cfg))
                res[f"{arch}/opt"] = _specs(SH.opt_state_specs(p, st))
                for c in spec.shapes:
                    res[f"{arch}/{c.name}/batch"] = _specs(
                        SH.recsys_batch_specs(cfg, mesh, c["batch"]))
        out[name] = res
    return out


def _jax_cells() -> dict:
    from repro.configs import all_cells, get_arch
    from repro.launch.cells import VARIANTS, SkippedCell, build_cell
    from repro.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh()
    kinds = {(a, s): get_arch(a).cell(s).kind for a, s in all_cells()}
    out = {"variants": sorted(VARIANTS), "cells": {}}
    for arch, shape, variant in cells(all_cells(), kinds):
        try:
            prog = build_cell(arch, shape, mesh, variant=variant)
        except SkippedCell as exc:
            out["cells"][cell_id(arch, shape, variant)] = {"skip": str(exc)}
            continue
        out["cells"][cell_id(arch, shape, variant)] = {
            "kind": prog.kind, "donate": list(prog.donate),
            "args": [_abstract(a) for a in prog.args],
            "in_specs": [_specs(s) for s in prog.in_specs],
            "out_specs": _specs(prog.out_specs),
            "meta": {k: v for k, v in prog.meta.items() if k != "cfg"}}
    return out


def _main(case: str, path: str) -> None:
    out = _jax_sharding() if case == "sharding" else _jax_cells()
    with open(path + ".tmp", "w") as f:
        json.dump(out, f, default=lambda x: list(x) if isinstance(x, tuple)
                  else str(x))
    os.replace(path + ".tmp", path)


if __name__ == "__main__":
    _main(*sys.argv[1:])


# ---------------------------------------------------------------------------
# the torch side: a rank of the sharded lookup's gradient
# ---------------------------------------------------------------------------
def lookup_grad_rank(rank, world, arch: str, params: dict, batch: dict,
                     mesh_shape: tuple) -> dict:
    """On one rank of a gloo mesh of ``mesh_shape`` (data, model): the
    reduced ``arch``'s loss (its table padded to the model axis, as the
    cell pads it) through the row-sharded lookup (the train cell's), its
    value and every parameter's gradient as host arrays."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed.collectives import make_sharded_lookup
    from repro_torch.launch.mesh import axis_group, make_mesh
    from repro_torch.models import recsys as R
    from repro_torch.train import tree as T
    from repro_torch.train.steps import _grads

    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              table_pad_to=mesh_shape[1])
    lookup = make_sharded_lookup(mesh, table_axis="model", batch_axes="data")
    p = T.tree_map(torch.tensor, params)
    b = {k: torch.tensor(v) for k, v in batch.items()}
    loss, _, g = _grads(lambda q, x: R.loss_fn(q, x, cfg, lookup_fn=lookup),
                        p, b)
    return {"index": axis_group(mesh, ("data", "model")).index,
            "loss": float(loss),
            "grads": {T.key_of(k): v.numpy()
                      for k, v in T.leaves_with_path(g)}}
