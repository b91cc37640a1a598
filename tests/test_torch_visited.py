"""The port's visited hash set against ``repro.core.visited``: probe
positions, tables and membership must agree bit for bit, because the
table layout decides ``evals`` once a table saturates."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import visited as jv
from repro_torch.core import visited as tv
from _torch_threads import _one_torch_thread  # noqa: F401

INVALID = -1


def _ids(rng, B, C, hi, p_invalid=0.1):
    ids = rng.integers(0, hi, size=(B, C)).astype(np.int32)
    ids[rng.random((B, C)) < p_invalid] = INVALID
    return ids


@pytest.mark.parametrize("n_slots,n_probes", [(16, 4), (1024, 4), (64, 1),
                                              (2 ** 20, 3)])
def test_probe_positions_match(n_slots, n_probes):
    rng = np.random.default_rng(n_slots)
    ids = rng.integers(-1, 2 ** 31 - 1, size=(5, 64)).astype(np.int32)
    ids[0, :4] = [INVALID, 0, 2 ** 31 - 1, 65535]
    want = np.asarray(jv.probe_positions(jnp.asarray(ids), n_slots, n_probes))
    got = tv.probe_positions(torch.from_numpy(ids), n_slots, n_probes)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,C,V,hi,rounds", [
    (4, 32, 1024, 5000, 3),      # sparse table
    (3, 64, 16, 40, 4),          # saturation: most inserts dropped
    (2, 48, 32, 8, 2),           # heavy same-slot races and repeats
])
def test_insert_and_contains_match(B, C, V, hi, rounds):
    rng = np.random.default_rng(B * 1000 + V)
    jt = jv.make_table(B, V)
    tt = tv.make_table(B, V, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for _ in range(rounds):
        ids = _ids(rng, B, C, hi)
        mask = rng.random((B, C)) < 0.8
        jt = jv.insert(jt, jnp.asarray(ids), jnp.asarray(mask))
        tt = tv.insert(tt, torch.from_numpy(ids), torch.from_numpy(mask))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        probe = _ids(rng, B, C, hi)
        np.testing.assert_array_equal(
            tv.contains(tt, torch.from_numpy(probe)).numpy(),
            np.asarray(jv.contains(jt, jnp.asarray(probe))))


def test_insert_is_pure_and_invalid_never_member():
    t0 = tv.make_table(2, 8, device="cpu")
    ids = torch.tensor([[INVALID, 3], [5, INVALID]], dtype=torch.int32)
    t1 = tv.insert(t0, ids, torch.ones_like(ids, dtype=torch.bool))
    assert (t0 == INVALID).all()
    assert not tv.contains(t1, ids)[ids == INVALID].any()
    assert tv.contains(t1, ids)[ids != INVALID].all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_occurrence_mask_matches(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 12, size=(6, 40)).astype(np.int32)
    valid = rng.random((6, 40)) < 0.7
    want = np.asarray(jv.first_occurrence_mask(jnp.asarray(ids),
                                               jnp.asarray(valid)))
    got = tv.first_occurrence_mask(torch.from_numpy(ids),
                                   torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("L,d", [(30, 20), (80, 20), (10, 4), (100, 30)])
def test_default_size_matches(L, d):
    assert tv.default_size(L, d) == jv.default_size(L, d)
    assert tv.make_table(1, 1000, device="cpu").shape[1] == 1024
