"""The port's snapshots (``repro_torch.persist``) against the JAX package's.

The port writes and reads the JAX package's file format: the envelope
round-trips and rejects damaged files with the port's typed errors; a
save and load gives back the same graph, vectors and stores, searching
exactly as before over every codec; a snapshot crosses between the
packages in both directions with every section and the payload unchanged,
and the port searches a JAX snapshot as the JAX package does (ids, hops
and evals exactly, dists at rtol 1e-6); a checkpointed build resumed from
its checkpoint is bit-identical to the uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import glob
import json

import numpy as np
import pytest

from repro.core.build import DEGIndex as JDEGIndex
from repro.core.build import DEGParams as JDEGParams
from repro.core.build import build_deg as j_build_deg
from repro.persist import load_index as j_load_index
from repro.persist import read_snapshot as j_read_snapshot
from repro_torch.core.build import DEGIndex, DEGParams, build_deg
from repro_torch.core.invariants import check_table1
from repro_torch.interop import result_to_numpy
from repro_torch.persist import (SnapshotChecksumError, SnapshotFormatError,
                                 load_index, read_snapshot, save_index,
                                 write_snapshot)

DIM = 8
CODECS = [None, "fp16", "sq8", "pq"]


def _params(**kw):
    return DEGParams(degree=8, k_ext=16, **kw)


def _mk(n=90, seed=0, refine=0, **params):
    vecs = np.random.default_rng(seed).normal(size=(n, DIM)).astype(
        np.float32)
    return build_deg(vecs, _params(**params), wave_size=8,
                     refine_iterations=refine, device="cpu"), vecs


def _queries(seed=99, b=4):
    return np.random.default_rng(seed).normal(size=(b, DIM)).astype(
        np.float32)


def _result(idx, q, codec=None):
    return result_to_numpy(idx.search_batch(q, k=5, eps=0.1,
                                            quantized=codec))


def _load(path, **kw):
    return DEGIndex.load(path, device="cpu", **kw)


@pytest.fixture(scope="module")
def built():
    idx, vecs = _mk(refine=20)
    for codec in ("fp16", "sq8", "pq"):
        idx.store_for(codec)
    return idx, vecs


# ---------------------------------------------------------------------------
# envelope
# ---------------------------------------------------------------------------
def test_envelope_payload_fidelity(tmp_path):
    p = tmp_path / "e.npz"
    payload = {"a": 1, "nested": {"b": [1, 2, 3], "c": "x"}, "f": 0.5,
               "none": None, "big": 2**100}
    secs = {"s": {"x": np.arange(6, dtype=np.int32).reshape(2, 3)}}
    write_snapshot(p, "test_kind", secs, payload)
    got_payload, got_secs = read_snapshot(p, expected_kind="test_kind")
    assert got_payload == payload
    np.testing.assert_array_equal(got_secs["s"]["x"], secs["s"]["x"])
    assert got_secs["s"]["x"].dtype == np.int32


def _forge(src, dst, mutate):
    with np.load(src) as z:
        arrays = {k: z[k].copy() for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode("utf-8"))
    mutate(meta, arrays)
    blob = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(dst, __meta__=blob, **arrays)
    return dst


def _bump(meta, arrays):
    meta["format_version"] = 999


def _flip(meta, arrays):
    arrays["graph/adjacency"].flat[0] += 1


def _drop(meta, arrays):
    del arrays["vectors/data"]


def _rekind(meta, arrays):
    meta["kind"] = "sharded_deg"


@pytest.mark.parametrize("mutate, err, match", [
    (_bump, SnapshotFormatError, "format_version 999"),
    (_flip, SnapshotChecksumError, "graph/adjacency"),
    (_drop, SnapshotFormatError, "vectors/data"),
    (_rekind, SnapshotFormatError, "kind"),
])
def test_damaged_snapshot_raises_typed(built, tmp_path, mutate, err, match):
    idx, _ = built
    good = tmp_path / "good.npz"
    idx.save(good)
    bad = _forge(good, tmp_path / "bad.npz", mutate)
    with pytest.raises(err, match=match):
        _load(bad)


# ---------------------------------------------------------------------------
# the single-index contract
# ---------------------------------------------------------------------------
def test_roundtrip_state_identical(built, tmp_path):
    idx, _ = built
    p = tmp_path / "i.npz"
    idx.save(p)
    twin = _load(p)
    n = idx.n
    assert twin.n == n and twin.capacity == idx.capacity
    np.testing.assert_array_equal(twin.builder.adjacency[:n],
                                  idx.builder.adjacency[:n])
    np.testing.assert_array_equal(twin.builder.weights[:n],
                                  idx.builder.weights[:n])
    np.testing.assert_array_equal(twin.vectors[:n], idx.vectors[:n])
    np.testing.assert_array_equal(twin._dev_vectors[:n].numpy(),
                                  idx._dev_vectors[:n].numpy())
    assert set(twin._stores) == {"fp16", "sq8", "pq"}
    for codec, s in idx._stores.items():
        t = twin._stores[codec]
        assert t.data.dtype == s.data.dtype and t.codec == codec
        np.testing.assert_array_equal(t.data[:n].numpy(), s.data[:n].numpy())
    # the sq8 scale and the pq codebooks come back verbatim (a re-encode
    # would re-calibrate, a re-fit re-run k-means)
    np.testing.assert_array_equal(twin._stores["sq8"].scale.numpy(),
                                  idx._stores["sq8"].scale.numpy())
    np.testing.assert_array_equal(twin._stores["pq"].codebooks.numpy(),
                                  idx._stores["pq"].codebooks.numpy())
    assert twin._stores["fp16"].scale is None
    assert twin._stores["pq"].scale is None
    assert twin._rng.bit_generator.state == idx._rng.bit_generator.state
    assert twin.build_stats == idx.build_stats
    assert twin._wave_counter == idx._wave_counter
    assert twin.params == idx.params


@pytest.mark.parametrize("codec", CODECS)
def test_roundtrip_search_identical(built, tmp_path, codec):
    idx, _ = built
    p = tmp_path / "i.npz"
    idx.save(p)
    twin = _load(p)
    q = _queries()
    a, b = _result(idx, q, codec), _result(twin, q, codec)
    for f in ("ids", "dists", "hops", "evals"):
        np.testing.assert_array_equal(a[f], b[f])


def test_restored_index_immediately_mutable(built, tmp_path):
    idx, _ = built
    p = tmp_path / "i.npz"
    idx.save(p)
    twin = _load(p)
    twin.add(np.random.default_rng(5).normal(size=(7, DIM)).astype(
        np.float32), wave_size=4)
    assert twin.n == idx.n + 7
    assert twin.remove([2]) == 1
    twin.refine(3, seed=0)
    assert twin.n == idx.n + 6
    assert all(check_table1(twin.builder).values())
    # a search after the mutations serves the compacted rows
    assert (_result(twin, _queries())["ids"] < twin.n).all()


def test_build_counters_and_medoid_roundtrip(built, tmp_path):
    idx, _ = built
    idx.medoid()
    p = tmp_path / "i.npz"
    idx.save(p)
    twin = _load(p)
    assert twin._medoid == idx._medoid == twin.medoid()


def test_params_override_and_structural_mismatch(built, tmp_path):
    idx, _ = built
    p = tmp_path / "i.npz"
    idx.save(p)
    twin = _load(p, params=_params(expand_width=2))
    assert twin.params.expand_width == 2
    with pytest.raises(ValueError, match="structurally incompatible"):
        _load(p, params=DEGParams(degree=10, k_ext=20))
    with pytest.raises(ValueError, match="structurally incompatible"):
        _load(p, params=_params(metric="ip"))


def test_load_with_grown_capacity(built, tmp_path):
    idx, _ = built
    p = tmp_path / "i.npz"
    idx.save(p)
    twin = _load(p, capacity=4 * idx.capacity)
    assert twin.capacity == 4 * idx.capacity and twin.n == idx.n
    smaller = _load(p, capacity=idx.capacity // 2)     # never shrinks
    assert smaller.capacity == idx.capacity
    q = _queries()
    for codec in CODECS:
        np.testing.assert_array_equal(_result(idx, q, codec)["ids"],
                                      _result(twin, q, codec)["ids"])


def test_hop_backend_names_in_the_file(tmp_path):
    """The file keeps the JAX package's hop names; the port maps its own
    to them and back."""
    idx, _ = _mk(n=30, hop_backend="fused")
    p = tmp_path / "f.npz"
    idx.save(p)
    payload, _ = read_snapshot(p)
    assert payload["params"]["hop_backend"] == "pallas"
    assert _load(p).params.hop_backend == "fused"
    assert j_load_index(p).params.hop_backend == "pallas"


def test_pending_only_index_roundtrips(tmp_path):
    idx = DEGIndex(DIM, _params(), capacity=32, device="cpu")
    pts = np.random.default_rng(3).normal(size=(4, DIM)).astype(np.float32)
    idx.add(pts)                       # 4 < degree + 1: still pending
    assert idx.builder is None
    p = tmp_path / "p.npz"
    idx.save(p)
    twin = _load(p)
    assert twin.builder is None and len(twin._pending) == 4
    more = np.random.default_rng(4).normal(size=(20, DIM)).astype(np.float32)
    idx.add(more, wave_size=4)
    twin.add(more, wave_size=4)
    np.testing.assert_array_equal(idx.builder.adjacency[: idx.n],
                                  twin.builder.adjacency[: twin.n])


def test_empty_index_roundtrips(tmp_path):
    idx = DEGIndex(DIM, _params(), capacity=32, device="cpu")
    p = tmp_path / "z.npz"
    idx.save(p)
    twin = _load(p)
    assert twin.n == 0 and twin.builder is None and not twin._pending


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_resume_bit_identical(tmp_path):
    """An interrupted build resumed from a checkpoint reproduces the
    uninterrupted build bit for bit (graph, weights, vectors, RNG)."""
    vecs = np.random.default_rng(11).normal(size=(120, DIM)).astype(
        np.float32)
    a = build_deg(vecs, _params(), wave_size=8, device="cpu")
    b = DEGIndex(DIM, _params(), capacity=120, device="cpu")
    b.enable_checkpoints(tmp_path / "ck_{waves}.npz", every_waves=3)
    b.add(vecs, wave_size=8)
    cks = sorted(glob.glob(str(tmp_path / "ck_*.npz")),
                 key=lambda s: int(s.rsplit("_", 1)[1].split(".")[0]))
    assert len(cks) >= 3
    for ck in (cks[len(cks) // 2], cks[-1]):
        c = _load(ck)                  # "crash" + warm resume
        assert 0 < c.n < 120
        c.add(vecs[c.n:], wave_size=8)
        np.testing.assert_array_equal(a.builder.adjacency[: a.n],
                                      c.builder.adjacency[: c.n])
        np.testing.assert_array_equal(a.builder.weights[: a.n],
                                      c.builder.weights[: c.n])
        np.testing.assert_array_equal(a.vectors[: a.n], c.vectors[: c.n])
        assert a._rng.bit_generator.state == c._rng.bit_generator.state


def test_checkpoint_overwrite_is_atomic(built, tmp_path):
    idx, _ = built
    p = tmp_path / "ck.npz"
    idx.save(p)
    idx.save(p)                        # overwrite the same path
    assert _load(p).n == idx.n
    assert [f.name for f in tmp_path.iterdir()] == ["ck.npz"]


def test_bad_checkpoint_template_fails_fast(built):
    idx, _ = built
    with pytest.raises(ValueError, match="checkpoint path template"):
        idx.enable_checkpoints("ck_{wave}.npz", every_waves=1)
    with pytest.raises(ValueError, match="checkpoint path template"):
        idx.enable_checkpoints("ck_{}.npz", every_waves=1)
    assert idx._ckpt_path is None      # config rejected, nothing armed


def test_refine_sweep_ticks_checkpoints(tmp_path):
    idx, _ = _mk(n=60, seed=2)
    idx.enable_checkpoints(tmp_path / "r_{waves}.npz", every_waves=1)
    idx.refine(40, seed=0)             # 3 chunks of 16: 2 boundaries + end
    files = glob.glob(str(tmp_path / "r_*.npz"))
    assert len(files) == 3
    twin = _load(sorted(files)[-1])
    assert all(check_table1(twin.builder).values())


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    """A JAX-built index with all three compressed stores, saved by the
    JAX package."""
    vecs = np.random.default_rng(21).normal(size=(90, DIM)).astype(
        np.float32)
    jidx = j_build_deg(vecs, JDEGParams(degree=8, k_ext=16), wave_size=8,
                       refine_iterations=20)
    for codec in ("fp16", "sq8", "pq"):
        jidx.store_for(codec)
    jidx.medoid()
    path = tmp_path_factory.mktemp("jax") / "j.npz"
    jidx.save(path)
    return jidx, path


def test_jax_to_port_to_jax_sections_and_payload_equal(jax_snapshot,
                                                       tmp_path):
    jidx, path = jax_snapshot
    tidx = load_index(path, device="cpu")
    assert tidx.params == DEGParams(**dict(
        dataclasses.asdict(jidx.params), hop_backend="composed"))
    back = tmp_path / "back.npz"
    save_index(tidx, back)
    want_payload, want = j_read_snapshot(path)
    got_payload, got = j_read_snapshot(back)
    assert got_payload == want_payload
    assert set(got) == set(want)
    for sec, entries in want.items():
        assert set(got[sec]) == set(entries), sec
        for name, arr in entries.items():
            assert got[sec][name].dtype == arr.dtype, (sec, name)
            np.testing.assert_array_equal(got[sec][name], arr)
    # the JAX package loads the port's file into the same index
    again = j_load_index(back)
    n = jidx.n
    np.testing.assert_array_equal(again.builder.adjacency[:n],
                                  jidx.builder.adjacency[:n])
    np.testing.assert_array_equal(np.asarray(again._stores["pq"].codebooks),
                                  np.asarray(jidx._stores["pq"].codebooks))
    assert again._rng.bit_generator.state == jidx._rng.bit_generator.state


@pytest.mark.parametrize("codec", CODECS)
def test_port_searches_a_jax_snapshot_like_jax(jax_snapshot, codec):
    jidx, path = jax_snapshot
    tidx = load_index(path, device="cpu")
    q = _queries(b=8)
    want = jidx.search_batch(q, k=5, eps=0.1, quantized=codec)
    got = _result(tidx, q, codec)
    for f in ("ids", "hops", "evals"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)))
    np.testing.assert_allclose(got["dists"], np.asarray(want.dists),
                               rtol=1e-6)


def test_port_snapshot_loads_into_jax(built, tmp_path):
    """A snapshot the port wrote searches alike in the JAX package."""
    idx, _ = built
    p = tmp_path / "t.npz"
    idx.save(p)
    jidx = JDEGIndex.load(p)
    assert set(jidx._stores) == {"fp16", "sq8", "pq"}
    np.testing.assert_array_equal(np.asarray(jidx._stores["fp16"].scale),
                                  np.ones(DIM, np.float32))
    q = _queries(b=8)
    for codec in CODECS:
        want = jidx.search_batch(q, k=5, eps=0.1, quantized=codec)
        got = _result(idx, q, codec)
        for f in ("ids", "hops", "evals"):
            np.testing.assert_array_equal(got[f],
                                          np.asarray(getattr(want, f)))
        np.testing.assert_allclose(got["dists"], np.asarray(want.dists),
                                   rtol=1e-6)
