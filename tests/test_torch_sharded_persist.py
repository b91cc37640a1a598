"""The port's sharded snapshots (``repro_torch.persist.sharded``) and the
host side of ``ShardedDEG`` against the JAX package's.

The twins of the sharded tests of ``tests/test_persist.py``,
``tests/test_persist_wal.py`` and ``tests/test_device_build.py``, and the
files across packages: a JAX-written sharded snapshot loads into the port
and a port-written one into the JAX package, sections and payload equal
both ways, and each package's search of either file gives the same ids
(dists at rtol 1e-6).  Searching takes a (model=2, data=2) mesh, as the
JAX test orders it: four gloo ranks here (``_torch_dist.persist_rank``),
four host devices in the JAX subprocess.  The ranks and the JAX
subprocess are the only processes this module starts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import _torch_dist as td
from repro.core.build import DEGParams as JDEGParams
from repro.distributed.index import build_sharded_deg as j_build_sharded_deg
from repro_torch.core.build import DEGParams
from repro_torch.core.invariants import assert_valid_deg, check_invariants
from repro_torch.data.synthetic import make_dataset
from repro_torch.distributed.index import ShardedDEG, build_sharded_deg
from repro_torch.interop import sharded_to_numpy
from repro_torch.launch.ranks import spawn_ranks
from repro_torch.persist import read_snapshot
from repro_torch.resilience.faults import FaultInjected, FaultPlan
from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_persist")
    port_path, jax_path = str(tmp / "port.npz"), str(tmp / "jax.npz")
    jax_out = str(tmp / "out.npz")
    vecs, _ = td.persist_data()
    sd = build_sharded_deg(vecs, 2, params=DEGParams(**td.PARAMS),
                           wave_size=td.WAVE, codec="sq8", device="cpu")
    sd.save(port_path)
    proc = td.start_jax("persist", jax_out, port_path, jax_path)
    try:
        ranks = spawn_ranks(td.persist_rank, 4,
                            (sharded_to_numpy(sd), port_path, jax_path),
                            timeout_s=240)
        jax = td.wait_jax(proc, jax_out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return dict(sd=sd, vecs=vecs, port_path=port_path, jax_path=jax_path,
                ranks=ranks, jax=jax)


def _load(path, **kw):
    return ShardedDEG.load(path, device="cpu", **kw)


def _files_equal(got_path, want_path):
    """Two snapshot files hold the same payload and the same sections,
    dtypes included."""
    want_payload, want = read_snapshot(want_path)
    got_payload, got = read_snapshot(got_path)
    assert got_payload == want_payload
    assert set(got) == set(want)
    for sec, entries in want.items():
        assert set(got[sec]) == set(entries), sec
        for name, arr in entries.items():
            assert got[sec][name].dtype == arr.dtype, (sec, name)
            np.testing.assert_array_equal(got[sec][name], arr)


def test_sharded_exact_restore(run):
    sd = run["sd"]
    sd2 = _load(run["port_path"])
    assert sd2.n_shards == sd.n_shards and sd2.codec == "sq8"
    for name in ("adjacency", "vectors", "n", "seeds", "codes", "scales"):
        assert (getattr(sd2, name) == getattr(sd, name)).all(), name
    for sh in sd2.shards:
        ok, msgs = check_invariants(sh.builder)
        assert ok, msgs


def test_sharded_restore_search_identical(run):
    for r in run["ranks"]:
        for f in ("ids", "dists"):
            np.testing.assert_array_equal(r[f"restored_{f}"], r[f"live_{f}"])
            np.testing.assert_array_equal(r[f"live_{f}"],
                                          run["ranks"][0][f"live_{f}"])


def test_sharded_reshard_on_restore(run):
    sd, vecs = run["sd"], run["vecs"]
    sd4 = _load(run["port_path"], n_shards=4)
    assert sd4.n_shards == 4 and sd4.n_total == sd.n_total
    assert sd4.codec == "sq8"
    # round-robin reassembly preserved the vector set exactly
    rebuilt = np.zeros_like(vecs)
    for s, sh in enumerate(sd4.shards):
        rebuilt[s::4] = sh.vectors[: sh.n]
        ok, msgs = check_invariants(sh.builder)
        assert ok, msgs
    np.testing.assert_array_equal(rebuilt, vecs)


def test_sharded_manifest_save_is_atomic(tmp_path):
    """The sharded manifest funnels through the same tmp+rename commit: a
    crash mid-save keeps the previous manifest intact."""
    pts = np.random.default_rng(0).normal(size=(24, 6)).astype(np.float32)
    sh = build_sharded_deg(pts, 2, DEGParams(degree=6, k_ext=12),
                           wave_size=4, device="cpu")
    path = tmp_path / "sharded.npz"
    sh.save(path)
    v1 = open(path, "rb").read()
    with FaultPlan().kill("snapshot.mid_save", at=1):
        with pytest.raises(FaultInjected):
            sh.save(path)
    assert open(path, "rb").read() == v1
    assert _load(path).n_total == 24


def test_sharded_refine_shard_local():
    """Shard-local refinement keeps every shard a valid DEG, refreshes the
    stacked adjacency, and refines edge for edge as the JAX package
    does."""
    base, _ = make_dataset("gaussian", 240, 10, 12, seed=21)
    kw = dict(degree=6, k_ext=12, eps_ext=0.3, k_opt=6, i_opt=5)
    sd = build_sharded_deg(base, 2, DEGParams(**kw), wave_size=16,
                           device="cpu")
    improved = sd.refine(40, seed=0)
    for sh in sd.shards:
        assert_valid_deg(sh.builder, context="shard after refine")
    adj = sd.adjacency.numpy()
    for s, sh in enumerate(sd.shards):
        np.testing.assert_array_equal(adj[s, : sh.n],
                                      sh.builder.adjacency[: sh.n])
    assert improved >= 0
    jsd = j_build_sharded_deg(base, 2, JDEGParams(**kw), wave_size=16)
    assert jsd.refine(40, seed=0) == improved
    np.testing.assert_array_equal(adj, np.asarray(jsd.adjacency))


def test_jax_file_loads_into_the_port(run, tmp_path):
    """A JAX-written sharded snapshot: the port's restore saves back to
    the same file contents, holds the JAX params, and searches as JAX
    searches it."""
    sd = _load(run["jax_path"])
    assert sd.params == DEGParams(**dict(td.PARAMS))
    assert sd.codec == "sq8" and sd.n_shards == 2
    back = tmp_path / "back.npz"
    sd.save(back)
    _files_equal(back, run["jax_path"])
    jax = run["jax"]
    np.testing.assert_array_equal(jax["jax_restored_ids"], jax["jax_ids"])
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["jax_file_ids"], jax["jax_ids"])
        np.testing.assert_allclose(r["jax_file_dists"], jax["jax_dists"],
                                   rtol=1e-6)


def test_port_file_loads_into_jax(run):
    """A port-written sharded snapshot: the JAX package's restore saves
    back to the same file contents and searches as the port does."""
    _files_equal(run["port_path"] + ".jax.npz", run["port_path"])
    jax, live = run["jax"], run["ranks"][0]
    assert int(jax["port_n_total"]) == run["sd"].n_total
    assert str(jax["port_codec"]) == "sq8"
    np.testing.assert_array_equal(jax["port_ids"], live["live_ids"])
    np.testing.assert_allclose(jax["port_dists"], live["live_dists"],
                               rtol=1e-6)


def test_params_in_the_manifest_keep_the_jax_names(run):
    manifest, _ = read_snapshot(run["port_path"])
    want = dataclasses.asdict(run["sd"].params)
    want["hop_backend"] = "jnp"
    assert manifest["params"] == want
    assert manifest["n_shards"] == 2 and manifest["codec"] == "sq8"
