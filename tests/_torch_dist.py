"""Both sides of the port's sharded tests, and the data they share.

* The data: numpy arrays drawn from fixed seeds, the inputs of
  ``tests/test_distributed.py``, ``tests/test_persist.py`` and
  ``tests/test_persist_wal.py``'s sharded cases, and the graph of
  ``tests/test_torch_egnn_sharded.py``.
* The JAX side: ``python tests/_torch_dist.py CASE OUT.npz [ARG]`` runs
  one case's JAX programs on four host devices and writes what they
  computed to ``OUT.npz`` (written whole, then renamed; a failed run
  writes ``OUT.npz.failed``).  :func:`start_jax` starts it as a
  subprocess, so the torch ranks run while it runs.
* The torch side: the rank functions that ``spawn_ranks`` runs on a
  ``(2, 2)`` gloo mesh of four ranks; each returns host arrays.

Only the JAX side imports JAX, inside :func:`_jax_main`: importing this
module loads neither JAX nor the JAX package.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

PARAMS = dict(degree=8, k_ext=16)
WAVE = 8
K = 5
EXCLUDE_WIDTH = 4
JAX_TIMEOUT_S = 240.0


# ---------------------------------------------------------------------------
# the data
# ---------------------------------------------------------------------------
def lookup_data():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(64, 8)).astype(np.float32)
    ids = rng.integers(0, 64, size=(10, 5)).astype(np.int32)
    return table, ids


def brute_data():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(6, 12)).astype(np.float32)
    db = rng.normal(size=(80, 12)).astype(np.float32)
    return q, db


def int8_data():
    return np.random.default_rng(2).normal(size=(128,)).astype(np.float32)


def psum_scale_data():
    """Four rows, one a rank; row 0 dominates by 1000x."""
    rng = np.random.default_rng(11)
    mags = np.array([1000.0, 1.0, 0.01, 1.0], np.float32)
    return (mags[:, None] * rng.normal(size=(4, 64))).astype(np.float32)


def psum_sum_data():
    return np.random.default_rng(3).normal(size=(4, 32)).astype(np.float32)


def grad_data():
    rng = np.random.default_rng(12)
    return {"w": rng.normal(size=(4, 8, 4)).astype(np.float32),
            "b": rng.normal(size=(4, 16)).astype(np.float32)}


def deg_data():
    """600 x 16 rows, 64 queries near the first 64, and an exclude list
    of EXCLUDE_WIDTH ids a query with INVALID slots (the first column the
    query's own row, INVALID every fifth query)."""
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(600, 16)).astype(np.float32)
    qs = vecs[:64] + 0.01 * rng.normal(size=(64, 16)).astype(np.float32)
    ex = np.random.default_rng(7).integers(-1, 600, size=(64, EXCLUDE_WIDTH))
    ex[:, 0] = np.arange(64)
    ex[::5, 0] = -1
    ex[::3, 2] = -1
    return vecs, qs, ex.astype(np.int32)


PERSIST_DIM = 8


def persist_data():
    vecs = np.random.default_rng(21).normal(size=(160, PERSIST_DIM)).astype(
        np.float32)
    q = np.random.default_rng(99).normal(size=(4, PERSIST_DIM)).astype(
        np.float32)
    return vecs, q


CODECS = ("float32", "sq8", "pq")
#: rerank widths of the JAX package's quantized sharded tests
RERANK = {"float32": 0, "sq8": 20, "pq": 40}


#: the reduced EGNN config's fields (``configs.get_arch("egnn").reduced()``)
EGNN_CFG = dict(n_layers=2, d_hidden=16, d_feat=24, n_classes=5)
EGNN_SHARDS = 4


def egnn_data(n: int = 40, e: int = 160) -> dict:
    """A graph of ``n`` nodes and ``e`` random edges, before partitioning;
    every seventh label -1."""
    rng = np.random.default_rng(31)
    labels = rng.integers(0, EGNN_CFG["n_classes"], size=n).astype(np.int32)
    labels[::7] = -1
    return {"feats": rng.normal(size=(n, EGNN_CFG["d_feat"])).astype(
                np.float32),
            "coords": rng.normal(size=(n, 3)).astype(np.float32),
            "edges": rng.integers(0, n, size=(2, e)).astype(np.int32),
            "labels": labels}


def egnn_batch(partition) -> dict:
    """:func:`egnn_data` with its edges through ``partition`` (either
    package's ``partition_edges_by_dst``) over EGNN_SHARDS shards."""
    d = egnn_data()
    d["edges"], d["edge_valid"] = partition(d["edges"], d["feats"].shape[0],
                                            EGNN_SHARDS)
    return d


def flat(tree: dict, prefix: str = "") -> dict:
    """A nested dict of arrays as one level of ``a/b/c`` keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflat(d: dict) -> dict:
    out: dict = {}
    for key, v in d.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def start_jax(case: str, out: str, *args) -> subprocess.Popen:
    """Run ``case`` of :func:`_jax_main` in a subprocess on four host
    devices; its outputs land in ``out``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             case, out, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def wait_jax(proc: subprocess.Popen, out: str) -> dict:
    """The JAX subprocess's outputs; its log in the error if it failed."""
    try:
        log, _ = proc.communicate(timeout=JAX_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX side exited {proc.returncode}:\n{log}")
    with np.load(out, allow_pickle=False) as z:
        return dict(z)


def wait_file(path: str, timeout_s: float = JAX_TIMEOUT_S) -> None:
    """Block until ``path`` exists; raise once ``path.failed`` does."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if os.path.exists(path + ".failed"):
            raise RuntimeError(f"the JAX side failed before writing {path}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written in {timeout_s} s")
        time.sleep(0.05)


def _jax_sharded(out: dict, four_shards: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import set_mesh, shard_map
    from repro.distributed.collectives import (
        compressed_psum, int8_compress, int8_decompress,
        make_compressed_grad_allreduce, make_sharded_lookup,
        sharded_brute_topk)
    from repro.core.build import DEGParams
    from repro.distributed.index import build_sharded_deg, make_sharded_search
    from repro.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh()
    table, ids = lookup_data()
    with set_mesh(mesh):
        out["lookup"] = jax.jit(make_sharded_lookup(mesh))(
            jnp.asarray(table), jnp.asarray(ids))
    q, db = brute_data()
    f = sharded_brute_topk(mesh, k=7, shard_axes=("data", "model"),
                           metric="l2")
    with set_mesh(mesh):
        out["brute_vals"], out["brute_ids"] = jax.jit(f)(jnp.asarray(q),
                                                          jnp.asarray(db))
    qi, s = int8_compress(jnp.asarray(int8_data()))
    out["int8_q"], out["int8_scale"] = qi, s
    out["int8_back"] = int8_decompress(qi, s)

    def per_device(fn, x):
        spec = P(("data", "model"), *([None] * (x.ndim - 1)))
        g = shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                      check_vma=False)
        with set_mesh(mesh):
            return jax.jit(g)(jnp.asarray(x))

    def psum(x):
        return compressed_psum(x, ("data", "model"))

    x = psum_scale_data()
    out["psum_scale"] = per_device(psum, x)
    out["psum_zero"] = per_device(psum, np.zeros_like(x))
    out["psum_sum"] = per_device(psum, psum_sum_data())
    grads = grad_data()
    reduce_tree = make_compressed_grad_allreduce(mesh, ("data", "model"))
    specs = {k: P(("data", "model"), *([None] * (v.ndim - 1)))
             for k, v in grads.items()}
    g = shard_map(reduce_tree, mesh=mesh, in_specs=(specs,),
                  out_specs=specs, check_vma=False)
    with set_mesh(mesh):
        got = jax.jit(g)({k: jnp.asarray(v) for k, v in grads.items()})
    for k, v in got.items():
        out[f"grad_{k}"] = v

    vecs, qs, ex = deg_data()
    sd = build_sharded_deg(vecs, 2, DEGParams(**PARAMS), wave_size=WAVE)
    for name in ("adjacency", "vectors", "n", "seeds"):
        out[name] = getattr(sd, name)
    for s, sh in enumerate(sd.shards):
        out[f"shard{s}_vectors"] = sh.vectors
        out[f"shard{s}_adjacency"] = sh.builder.adjacency
        out[f"shard{s}_weights"] = sh.builder.weights
        out[f"shard{s}_n"] = np.int32(sh.n)
    dropped = sd.drop_shard(0).n
    # one compiled step a configuration, called live and with shard 0
    # dropped (sd.search compiles anew on every call)
    for codec in CODECS:
        x = sd.quantize(codec) if codec != "float32" else sd
        if codec != "float32":
            out[f"{codec}_codes"], out[f"{codec}_scales"] = x.codes, x.scales
            out[f"{codec}_ratio"] = np.float64(x.memory_stats()["ratio"])
        if codec == "pq":
            out["pq_codebooks"] = x.codebooks
        f = jax.jit(make_sharded_search(mesh, k=K, codec=codec,
                                        rerank_k=RERANK[codec]))
        args = [x.adjacency, x.vectors] + (
            [] if codec == "float32" else [x.codes, x.scales]) + (
            [x.codebooks] if codec == "pq" else [])
        for tag, n in ((codec, x.n), (f"{codec}_drop", dropped)):
            with set_mesh(mesh):
                out[f"{tag}_ids"], out[f"{tag}_dists"] = f(
                    *args, n, x.seeds, jnp.asarray(qs))
    f = jax.jit(make_sharded_search(mesh, k=K, exclude_width=EXCLUDE_WIDTH))
    with set_mesh(mesh):
        out["explore_ids"], out["explore_dists"] = f(
            sd.adjacency, sd.vectors, sd.n, sd.seeds, jnp.asarray(qs),
            jnp.asarray(ex))
    # the port's four shards over a model axis of two: JAX searches
    # shards 0 and 2 and numbers their ids as if there were two
    wait_file(four_shards)
    with np.load(four_shards) as z:
        f = jax.jit(make_sharded_search(mesh, k=K))
        with set_mesh(mesh):
            out["wrong4_ids"], out["wrong4_dists"] = f(
                *(jnp.asarray(z[name]) for name in (
                    "adjacency", "vectors", "n", "seeds")), jnp.asarray(qs))


def _jax_persist(out: dict, port_path: str, jax_path: str) -> None:
    """Save a JAX-built sq8 ShardedDEG to ``jax_path``; load the port's
    file at ``port_path`` and save it again beside it; search both."""
    import jax
    from jax.sharding import Mesh

    from repro.core.build import DEGParams
    from repro.distributed.index import ShardedDEG, build_sharded_deg

    vecs, q = persist_data()
    sd = build_sharded_deg(vecs, 2, params=DEGParams(**PARAMS),
                           wave_size=WAVE, codec="sq8")
    sd.save(jax_path + ".tmp.npz")
    os.replace(jax_path + ".tmp.npz", jax_path)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("model", "data"))
    out["jax_ids"], out["jax_dists"] = sd.search(mesh, q, k=K)
    out["jax_restored_ids"], out["jax_restored_dists"] = ShardedDEG.load(
        jax_path).search(mesh, q, k=K)
    port = ShardedDEG.load(port_path)
    port.save(port_path + ".jax.npz")
    out["port_ids"], out["port_dists"] = port.search(mesh, q, k=K)
    out["port_n_total"] = np.int64(port.n_total)
    out["port_codec"] = np.array(port.codec)


def _jax_egnn(out: dict, params_path: str) -> None:
    """The JAX package's halo loss on the (2, 2) debug mesh and its
    ``loss_fn`` on the same partitioned graph, each with its gradients."""
    import jax
    import jax.numpy as jnp

    from repro.compat import set_mesh
    from repro.data.graphs import partition_edges_by_dst
    from repro.launch.mesh import make_debug_mesh
    from repro.models import egnn as E

    cfg = E.EGNNConfig(name="egnn-reduced", **EGNN_CFG)
    with np.load(params_path) as z:
        params = jax.tree.map(jnp.asarray, unflat(dict(z)))
    batch = {k: jnp.asarray(v)
             for k, v in egnn_batch(partition_edges_by_dst).items()}
    mesh = make_debug_mesh()
    sharded = E.make_sharded_loss(cfg, mesh, ("data", "model"))
    with set_mesh(mesh):
        (loss, _), g = jax.jit(jax.value_and_grad(sharded, has_aux=True))(
            params, batch)
    out["sharded_loss"] = loss
    out.update(flat(g, "sharded_grad/"))
    (loss, _), g = jax.value_and_grad(
        lambda p: E.loss_fn(p, batch, cfg), has_aux=True)(params)
    out["full_loss"] = loss
    out.update(flat(g, "full_grad/"))


def _jax_main(case: str, path: str, *args) -> None:
    out: dict = {}
    try:
        if case == "sharded":
            _jax_sharded(out, *args)
        elif case == "persist":
            _jax_persist(out, *args)
        elif case == "egnn":
            _jax_egnn(out, *args)
        else:
            raise ValueError(f"unknown case {case!r}")
        np.savez(path + ".tmp.npz", **{k: np.asarray(v)
                                       for k, v in out.items()})
        os.replace(path + ".tmp.npz", path)
    except BaseException:
        open(path + ".failed", "w").close()
        raise


# ---------------------------------------------------------------------------
# the torch side (rank functions for repro_torch.launch.ranks.spawn_ranks)
# ---------------------------------------------------------------------------
def _np(t):
    return t.cpu().numpy()


def searcher(d: dict):
    """A search-only port ShardedDEG on the CPU from
    ``interop.sharded_to_numpy``'s dict or :func:`from_jax`'s."""
    from repro_torch.interop import sharded_from_numpy

    return sharded_from_numpy(**d, device="cpu")


def from_jax(z: dict, codec: str = "float32") -> dict:
    """``interop.sharded_to_numpy``'s dict of the JAX side's sharded DEG
    (``z`` its npz) under ``codec``."""
    d = {name: z[name] for name in ("adjacency", "vectors", "n", "seeds")}
    d.update(params=dict(PARAMS), codec=codec, codes=None, scales=None,
             codebooks=None)
    if codec != "float32":
        d["codes"], d["scales"] = z[f"{codec}_codes"], z[f"{codec}_scales"]
        d["codebooks"] = z["pq_codebooks"] if codec == "pq" else None
    return d


def deg_searches(mesh, indexes: dict) -> dict:
    """Every DEG search of the sharded tests over ``indexes`` (codec ->
    :func:`searcher`'s dict of one source's sub-DEGs): each codec live and
    with shard 0 dropped, and exploration over the float32 index."""
    import torch

    from repro_torch.distributed.index import make_sharded_search

    _, qs, ex = deg_data()
    out = {}
    for codec, d in indexes.items():
        sd = searcher(d)
        for tag, x in ((codec, sd), (f"{codec}_drop", sd.drop_shard(0))):
            ids, dists = x.search(mesh, qs, k=K, rerank_k=RERANK[codec])
            out[f"{tag}_ids"], out[f"{tag}_dists"] = _np(ids), _np(dists)
    f = make_sharded_search(mesh, k=K, exclude_width=EXCLUDE_WIDTH)
    ids, dists = f(*searcher(indexes["float32"]).search_args(),
                   torch.tensor(qs), torch.tensor(ex))
    out["explore_ids"], out["explore_dists"] = _np(ids), _np(dists)
    return out


def sharded_rank(rank, world, port: dict, four_shards: dict,
                 jax_out: str) -> dict:
    """Every case of ``tests/test_torch_sharded.py`` on one rank of the
    (2, 2) debug mesh: first on the port's own builds (``port``, codec ->
    :func:`searcher`'s dict), then, once the JAX side has written ``jax_out``, on
    its sub-DEGs carried across."""
    import torch

    from repro_torch.distributed.collectives import (
        compressed_psum, make_compressed_grad_allreduce, make_sharded_lookup,
        sharded_brute_topk)
    from repro_torch.launch.mesh import axis_group, make_debug_mesh

    mesh = make_debug_mesh("cpu")
    every = axis_group(mesh, ("data", "model"))
    out = {"index": every.index,
           "backends": {str(a): axis_group(mesh, a).backend
                        for a in ("data", "model", ("data", "model"))}}
    table, ids = lookup_data()
    out["lookup"] = _np(make_sharded_lookup(mesh)(torch.tensor(table),
                                                  torch.tensor(ids)))
    q, db = brute_data()
    vals, bids = sharded_brute_topk(mesh, k=7, shard_axes=("data", "model"),
                                    metric="l2")(torch.tensor(q),
                                                 torch.tensor(db))
    out["brute_vals"], out["brute_ids"] = _np(vals), _np(bids)

    def mine(x):
        return torch.tensor(x[every.index: every.index + 1])

    x = psum_scale_data()
    out["psum_scale"] = _np(compressed_psum(mine(x), every))
    out["psum_zero"] = _np(compressed_psum(mine(np.zeros_like(x)), every))
    out["psum_sum"] = _np(compressed_psum(mine(psum_sum_data()), every))
    grads = make_compressed_grad_allreduce(mesh, ("data", "model"))(
        {k: mine(v) for k, v in grad_data().items()})
    out["grad"] = {k: _np(v) for k, v in grads.items()}

    out["port"] = deg_searches(mesh, port)
    try:
        searcher(four_shards).search(mesh, deg_data()[1], k=K)
        out["four_shards"] = "searched"
    except ValueError as e:
        out["four_shards"] = f"ValueError: {e}"

    wait_file(jax_out)
    with np.load(jax_out) as z:
        z = dict(z)
    out["jax"] = deg_searches(mesh, {c: from_jax(z, c) for c in CODECS})
    return out


def persist_rank(rank, world, live: dict, port_path: str,
                 jax_path: str) -> dict:
    """On a (model=2, data=2) mesh, as the JAX package's test orders it:
    search the port's live sharded index, its exact restore, and the JAX
    package's file once written."""
    from repro_torch.distributed.index import ShardedDEG
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("model", "data"), "cpu")
    _, q = persist_data()
    out = {}

    def search(tag, sd):
        ids, dists = sd.search(mesh, q, k=K)
        out[f"{tag}_ids"], out[f"{tag}_dists"] = _np(ids), _np(dists)

    search("live", searcher(live))
    search("restored", ShardedDEG.load(port_path, device="cpu"))
    wait_file(jax_path)
    search("jax_file", ShardedDEG.load(jax_path, device="cpu"))
    return out


def egnn_halo_rank(rank, world, params: dict) -> dict:
    """The port's halo loss on one rank of the (2, 2) debug mesh over
    :func:`egnn_batch` (``params`` :func:`flat`'s dict), with every
    parameter's gradient; and three probes of the differentiable
    collectives on this rank's row of ones: ``psum_forward``'s gradient
    (ones, not the world size), ``replicated``'s (the world size: one
    from each rank) and ``all_gather_rows``' (each rank's block summed
    over the ranks)."""
    import torch

    from repro_torch.data.graphs import partition_edges_by_dst
    from repro_torch.distributed.collectives import (all_gather_rows,
                                                     psum_forward, replicated)
    from repro_torch.interop import egnn_params_from_numpy
    from repro_torch.launch.mesh import axis_group, make_debug_mesh
    from repro_torch.models import egnn as E
    from repro_torch.train import tree as T

    mesh = make_debug_mesh("cpu")
    ag = axis_group(mesh, ("data", "model"))
    cfg = E.EGNNConfig(name="egnn-reduced", **EGNN_CFG)
    batch = {k: torch.tensor(v)
             for k, v in egnn_batch(partition_edges_by_dst).items()}
    views = T.tree_map(lambda t: t.requires_grad_(),
                       egnn_params_from_numpy(unflat(params), "cpu"))
    loss, _ = E.make_sharded_loss(cfg, mesh, ("data", "model"))(views, batch)
    grads = torch.autograd.grad(loss, T.leaves(views))
    out = {"index": ag.index, "backend": ag.backend,
           "loss": _np(loss.detach()),
           "grads": flat(T.unflatten(views, [_np(g) for g in grads]))}
    x = torch.ones(3, requires_grad=True)
    out["psum_grad"] = _np(torch.autograd.grad(psum_forward(x.sum(), ag),
                                               x)[0])
    out["replicated_grad"] = _np(torch.autograd.grad(
        replicated(x, ag).sum(), x)[0])
    rows = torch.ones(2, 2, requires_grad=True)
    full = all_gather_rows(rows, ag)
    w = torch.arange(full.shape[0], dtype=torch.float32)[:, None]
    out["gather_rows"] = _np(full.detach())
    out["gather_grad"] = _np(torch.autograd.grad((full * w).sum(), rows)[0])
    return out


if __name__ == "__main__":
    _jax_main(*sys.argv[1:])
