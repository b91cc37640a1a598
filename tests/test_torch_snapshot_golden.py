"""The pinned v1 snapshot fixture read by the port's own reader.

``tests/data/index_snapshot_golden.npz`` is a complete index the JAX
package persisted, with its expected search outputs embedded.  The
port's ``load_index`` must read it (n 120, Table-1 invariants, the sq8
store present) and serve the pinned exact and sq8 results: ids exactly,
distances at rtol 1e-6 (the pinned distances are 1 ulp off under the
installed jax, ROADMAP C2).  A forged ``format_version``, a flipped
checksum, a missing section, a wrong kind and a foreign npz are rejected
with the port's typed errors.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from repro_torch.core.invariants import check_table1
from repro_torch.interop import result_to_numpy
from repro_torch.persist import (SnapshotChecksumError, SnapshotFormatError,
                                 load_index, read_snapshot)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "index_snapshot_golden.npz")


def _patched_copy(tmp_path, mutate):
    """Copy the golden archive with ``mutate(meta_dict, arrays_dict)``
    applied."""
    with np.load(GOLDEN) as z:
        arrays = {k: z[k].copy() for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode("utf-8"))
    mutate(meta, arrays)
    blob = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    path = tmp_path / "patched.npz"
    np.savez_compressed(path, __meta__=blob, **arrays)
    return path


def _load(path):
    return load_index(path, device="cpu")


@pytest.fixture(scope="module")
def golden_index():
    return _load(GOLDEN)


@pytest.fixture(scope="module")
def expected():
    _, sections = read_snapshot(GOLDEN)
    return sections["expected"]


def test_golden_loads_and_is_valid(golden_index):
    assert golden_index.n == 120
    assert all(check_table1(golden_index.builder).values())
    assert set(golden_index._stores) == {"sq8"}
    assert golden_index._stores["sq8"].scale.shape == (8,)
    assert golden_index.params.hop_backend == "composed"     # file: "jnp"
    assert golden_index._wal_seq == 0                         # pre-WAL file


@pytest.mark.parametrize("codec", [None, "sq8"])
def test_golden_search_pinned(golden_index, expected, codec):
    tag = "sq8" if codec else "exact"
    got = result_to_numpy(golden_index.search_batch(
        expected["queries"], k=10, eps=0.1, quantized=codec))
    np.testing.assert_array_equal(got["ids"], expected[f"{tag}_ids"])
    np.testing.assert_allclose(got["dists"], expected[f"{tag}_dists"],
                               rtol=1e-6)


def test_golden_round_trips(golden_index, tmp_path):
    """load -> save -> load is state-identical in the port."""
    p = tmp_path / "resaved.npz"
    golden_index.save(p)
    again = _load(p)
    n = golden_index.n
    np.testing.assert_array_equal(golden_index.builder.adjacency[:n],
                                  again.builder.adjacency[:n])
    np.testing.assert_array_equal(golden_index.builder.weights[:n],
                                  again.builder.weights[:n])
    np.testing.assert_array_equal(golden_index.vectors[:n],
                                  again.vectors[:n])
    np.testing.assert_array_equal(golden_index._stores["sq8"].data.numpy(),
                                  again._stores["sq8"].data.numpy())
    assert (golden_index._rng.bit_generator.state
            == again._rng.bit_generator.state)


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
def test_damaged_golden_rejected(tmp_path, mutate, err, match):
    path = _patched_copy(tmp_path, mutate)
    with pytest.raises(err, match=match):
        _load(path)


def test_foreign_npz_rejected(tmp_path):
    path = tmp_path / "foreign.npz"
    np.savez(path, stuff=np.arange(3))
    with pytest.raises(SnapshotFormatError, match="not a repro snapshot"):
        _load(path)
