"""The port's sharded DEG and collectives (``repro_torch.distributed``,
``launch/mesh.py``) against the JAX package's on the same inputs.

The torch side is one group of four gloo ranks on the ``(2, 2)`` debug
mesh (``_torch_dist.sharded_rank``), which runs every case once; the JAX
side runs the twins on four host devices in a subprocess started first,
so that the two overlap.  The tests then compare: ids, merged orders,
codes and adjacency exactly, distances at rtol 1e-6 (the C2 margin), and
each case of ``tests/test_distributed.py`` (but the LM step) on the
port's own output as well.  The ranks and the JAX subprocess are the
only processes this module starts.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import _torch_dist as td
from repro.distributed.collectives import int8_compress as j_int8_compress
from repro.distributed.collectives import int8_decompress as j_int8_decompress
from repro_torch.core.build import DEGParams
from repro_torch.core.graph import INVALID
from repro_torch.core.search import range_search
from repro_torch.distributed.collectives import int8_compress, int8_decompress
from repro_torch.distributed.index import build_sharded_deg
from repro_torch.interop import sharded_to_numpy
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.ranks import process_group, spawn_ranks
from _torch_threads import _one_torch_thread  # noqa: F401

SOURCES = ("port", "jax")
TAGS = ("float32", "float32_drop", "sq8", "sq8_drop", "pq", "pq_drop",
        "explore")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    jax_out, four = str(tmp / "jax.npz"), str(tmp / "four.npz")
    proc = td.start_jax("sharded", jax_out, four)
    try:
        vecs, _, _ = td.deg_data()
        params = DEGParams(**td.PARAMS)
        sd = build_sharded_deg(vecs, 2, params, wave_size=td.WAVE,
                               device="cpu")
        sd4 = build_sharded_deg(vecs, 4, params, wave_size=td.WAVE,
                                device="cpu")
        four_d = sharded_to_numpy(sd4)
        np.savez(four + ".tmp.npz", **{k: four_d[k] for k in (
            "adjacency", "vectors", "n", "seeds")})
        os.replace(four + ".tmp.npz", four)
        built = {"float32": sd, "sq8": sd.quantize("sq8"),
                 "pq": sd.quantize("pq")}
        ranks = spawn_ranks(
            td.sharded_rank, 4,
            ({c: sharded_to_numpy(x) for c, x in built.items()}, four_d, jax_out),
            timeout_s=240)
        jax = td.wait_jax(proc, jax_out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    ranks.sort(key=lambda r: r["index"])
    return {"built": built, "ranks": ranks, "r0": ranks[0], "jax": jax}


def _recall(ids, gt):
    return np.mean([len(set(ids[i]) & set(gt[i])) / gt.shape[1]
                    for i in range(len(gt))])


def _gt(k=td.K):
    vecs, qs, _ = td.deg_data()
    d2 = ((qs[:, None] - vecs[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1)[:, :k], d2


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_every_rank_returns_the_same_and_runs_gloo(run):
    first = run["r0"]
    assert [r["index"] for r in run["ranks"]] == [0, 1, 2, 3]
    for r in run["ranks"][1:]:
        _same({k: v for k, v in r.items() if k != "index"},
              {k: v for k, v in first.items() if k != "index"})
    assert set(first["backends"].values()) == {"gloo"}


def test_sharded_lookup_matches_gather(run):
    table, ids = td.lookup_data()
    got = run["r0"]["lookup"]
    np.testing.assert_allclose(got, table[ids], rtol=1e-6)
    np.testing.assert_allclose(got, run["jax"]["lookup"], rtol=1e-6)


def test_sharded_brute_topk_exact(run):
    q, db = td.brute_data()
    ids, vals = run["r0"]["brute_ids"], run["r0"]["brute_vals"]
    d2 = ((q[:, None] - db[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :7]
    assert (np.sort(ids, 1) == np.sort(gt, 1)).all()
    np.testing.assert_array_equal(ids, run["jax"]["brute_ids"])
    np.testing.assert_allclose(vals, run["jax"]["brute_vals"], rtol=1e-6)


def test_int8_compression_roundtrip(run):
    x = td.int8_data()
    q, s = int8_compress(torch.tensor(x))
    back = int8_decompress(q, s)
    assert q.dtype == torch.int8
    np.testing.assert_allclose(back.numpy(), x, atol=0.02)
    np.testing.assert_array_equal(q.numpy(), run["jax"]["int8_q"])
    np.testing.assert_allclose(s.numpy(), run["jax"]["int8_scale"],
                               rtol=1e-6)
    np.testing.assert_allclose(back.numpy(), run["jax"]["int8_back"],
                               rtol=1e-6)
    # and the JAX functions on the same input, in this process
    jq, js = j_int8_compress(x)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(j_int8_decompress(jq, js)),
                               rtol=1e-6)


def _rows(run, key):
    return np.concatenate([r[key] for r in run["ranks"]])


def test_compressed_psum_global_scale_agreement(run):
    """Ranks of very different magnitudes agree on one global scale: every
    rank's sum is the same bits, within the global amax's bound, and an
    all-zero input stays exactly zero."""
    x = td.psum_scale_data()
    out = _rows(run, "psum_scale")
    assert (out == out[0][None, :]).all()
    assert np.abs(out[0] - x.sum(0)).max() <= 4 * np.abs(x).max() / 127 + 1e-6
    assert (_rows(run, "psum_zero") == 0).all()
    np.testing.assert_allclose(out, run["jax"]["psum_scale"], rtol=1e-6)
    np.testing.assert_array_equal(_rows(run, "psum_zero"),
                                  run["jax"]["psum_zero"])


def test_compressed_psum_approximates_sum(run):
    x = td.psum_sum_data()
    out = _rows(run, "psum_sum")
    want = np.broadcast_to(x.sum(0, keepdims=True), (4, 32))
    np.testing.assert_allclose(out, want,
                               atol=4 * np.abs(x).max() / 127 + 1e-6)
    np.testing.assert_allclose(out, run["jax"]["psum_sum"], rtol=1e-6)


def test_compressed_grad_allreduce_tree(run):
    grads = td.grad_data()
    for k, v in grads.items():
        got = np.concatenate([r["grad"][k] for r in run["ranks"]])
        assert got.dtype == np.float32
        want = v.mean(0, keepdims=True)
        assert np.abs(got - np.broadcast_to(want, got.shape)).max() <= \
            np.abs(v).max() / 127 + 1e-6
        np.testing.assert_allclose(got, run["jax"][f"grad_{k}"], rtol=1e-6)


@pytest.mark.parametrize("source", SOURCES)
def test_sharded_deg_recall_and_shard_loss(run, source):
    res = run["r0"][source]
    gt, _ = _gt()
    rec = _recall(res["float32_ids"], gt)
    assert rec > 0.8
    # losing a shard: service continues, only that shard's ids disappear
    ids2 = res["float32_drop_ids"]
    assert (ids2 % 2 == 1).all()
    rec2 = _recall(ids2, gt)
    assert 0.3 < rec2 < rec


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("codec,slack", [("sq8", 0.01), ("pq", 0.05)])
def test_sharded_deg_two_stage(run, source, codec, slack):
    """Quantized shard-local traversal + exact rerank after the merge:
    recall holds near the float path, the returned distances are the
    exact float distances of the returned ids, and shard loss degrades
    gracefully."""
    res = run["r0"][source]
    gt, d2 = _gt()
    ids_q, dists_q = res[f"{codec}_ids"], res[f"{codec}_dists"]
    assert _recall(ids_q, gt) >= _recall(res["float32_ids"], gt) - slack
    for i in range(len(gt)):
        valid = ids_q[i] >= 0
        np.testing.assert_allclose(dists_q[i][valid],
                                   np.sqrt(d2[i][ids_q[i][valid]]),
                                   rtol=1e-5)
    assert (res[f"{codec}_drop_ids"] % 2 == 1).all()
    x = run["built"][codec]
    if codec == "sq8":
        assert x.memory_stats()["ratio"] >= 3.5
    else:
        assert x.codebooks.shape[0] == 2          # one codebook per shard
    assert x.memory_stats()["ratio"] == pytest.approx(
        float(run["jax"][f"{codec}_ratio"]))


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("tag", TAGS)
def test_search_matches_jax(run, source, tag):
    """The port's sharded search over its own build and over the JAX
    package's sub-DEGs gives JAX's ids exactly and its dists at rtol
    1e-6."""
    got, want = run["r0"][source], run["jax"]
    np.testing.assert_array_equal(got[f"{tag}_ids"], want[f"{tag}_ids"])
    np.testing.assert_allclose(got[f"{tag}_dists"], want[f"{tag}_dists"],
                               rtol=1e-6)


def test_build_and_codes_equal_jax(run):
    got = sharded_to_numpy(run["built"]["float32"])
    for name in ("adjacency", "vectors", "n", "seeds"):
        np.testing.assert_array_equal(got[name], run["jax"][name])
    for s, sh in enumerate(run["built"]["float32"].shards):
        np.testing.assert_array_equal(
            sh.builder.adjacency[: sh.n],
            run["jax"][f"shard{s}_adjacency"][: sh.n])
        np.testing.assert_allclose(sh.builder.weights[: sh.n],
                                   run["jax"][f"shard{s}_weights"][: sh.n],
                                   rtol=1e-6)
    for codec in ("sq8", "pq"):
        x = sharded_to_numpy(run["built"][codec])
        np.testing.assert_array_equal(x["codes"], run["jax"][f"{codec}_codes"])
        np.testing.assert_array_equal(x["scales"],
                                      run["jax"][f"{codec}_scales"])
    np.testing.assert_array_equal(sharded_to_numpy(run["built"]["pq"])["codebooks"],
                                  run["jax"]["pq_codebooks"])


@pytest.mark.parametrize("source", SOURCES)
def test_exploration_excludes_and_handles_invalid_slots(run, source):
    """Excluded ids (INVALID slots among them) never come back, and a
    query whose own id is INVALID still searches from the shard seeds."""
    _, _, ex = td.deg_data()
    ids = run["r0"][source]["explore_ids"]
    for i in range(len(ids)):
        got = set(ids[i][ids[i] != INVALID].tolist())
        assert not got & set(ex[i][ex[i] != INVALID].tolist())
        assert len(got) == td.K
    assert (ex[::5, 0] == INVALID).all()


def test_shard_count_must_equal_model_axis(run):
    """Kept difference: JAX searches an index of 4 shards over a model axis
    of 2 and returns ids whose rows are not at the returned distances; the
    port raises."""
    assert run["r0"]["four_shards"].startswith("ValueError: 4 shards")
    vecs, qs, _ = td.deg_data()
    ids, dists = run["jax"]["wrong4_ids"], run["jax"]["wrong4_dists"]
    true = np.linalg.norm(qs[:, None] - vecs[ids], axis=-1)
    wrong = ~np.isclose(true, dists, rtol=1e-4)
    assert wrong.mean() > 0.5


def test_world_size_one_equals_range_search():
    """At world size 1 (a (1, 1) mesh) the sharded search of one shard is
    the shard's own range_search, and an index of 2 shards raises."""
    vecs, qs, _ = td.deg_data()
    params = DEGParams(**td.PARAMS)
    sd = build_sharded_deg(vecs[:300], 1, params, wave_size=td.WAVE,
                           device="cpu")
    with process_group("gloo"):
        mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), "cpu")
        ids, dists = sd.search(mesh, qs, k=td.K)
        sd2 = build_sharded_deg(vecs[:60], 2, params, wave_size=td.WAVE,
                                device="cpu")
        with pytest.raises(ValueError, match="2 shards"):
            sd2.search(mesh, qs, k=td.K)
    sh = sd.shards[0]
    seeds = torch.full((len(qs), 1), sh.medoid(), dtype=torch.int32)
    want = range_search(sh.frozen(), sh._dev_vectors, torch.tensor(qs),
                        seeds, k=td.K, eps=0.1)
    assert torch.equal(ids, want.ids)
    assert torch.equal(dists, want.dists)


def test_batch_axes_of_a_three_axis_mesh():
    from torch.distributed.device_mesh import DeviceMesh

    shape, names = mesh_mod.DEBUG[True]
    # the mesh's shape and names, without eight ranks behind it
    with process_group("gloo"):
        mesh3 = DeviceMesh("cpu", torch.arange(8).reshape(shape),
                           mesh_dim_names=names, _init_backend=False)
    assert mesh3.mesh_dim_names == ("pod", "data", "model")
    assert mesh_mod.batch_axes(mesh3) == ("pod", "data")
    assert mesh_mod.model_axis(mesh3) == "model"
    assert mesh_mod.mesh_devices(mesh3) == 8
    assert mesh_mod.PRODUCTION[True] == ((2, 16, 16),
                                         ("pod", "data", "model"))
    assert mesh_mod.PRODUCTION[False] == ((16, 16), ("data", "model"))
