"""A rehearsal of ``chip_smoke.py``'s phase 11 on the CPU at n=600: the
world-size-1 sharded search (gloo here, NCCL on the card), the two-shard
builds, graph quality, the sq8 and pq shard stores, the sharded snapshot
and its reshard, then four gloo ranks on the debug mesh running every
search and collective of 11c; and a rank that raises fails the phase.
The card-only pieces are replaced as in ``tests/test_torch_chip_smoke.py``;
every expected launch count reads 0 on the CPU.  The ranks are the only
processes this module starts."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from repro_torch.launch.ranks import RankFailed  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: F401

N, N_QUERIES, BATCH, N_HOST = 600, 64, 32, 300


def _no_launches(kernel, got, want, what):
    assert got == 0, f"{got} {kernel} launches on the CPU"


@pytest.fixture(scope="module")
def rehearsal():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "sync", lambda: None)
        mp.setattr(cs, "idle_share", lambda fn, wall_ms, what: None)
        mp.setattr(cs, "expect_launches", _no_launches)
        yield mp


@pytest.fixture(scope="module")
def world1(rehearsal, tmp_path_factory):
    """11a, 11b and 11d at world size 1, over the rehearsal's data and
    its exact ground truth; the stacked tensors written for 11c."""
    from repro_torch.core.distances import exact_knn_batched
    from repro_torch.data.synthetic import make_dataset

    base, queries = make_dataset("manifold", N, N_QUERIES, cs.DIM, seed=0)
    _, gt = exact_knn_batched(queries, base, cs.K, device="cpu")
    tmp = str(tmp_path_factory.mktemp("phase11"))
    out = cs.world1_phase(base, queries, gt, "cpu", cs._no_count, tmp,
                          batch=BATCH, n_host=N_HOST)
    return out, queries, gt, tmp


def test_phase11_world1(world1):
    out, _, _, tmp = world1
    assert out["world1_recall"] >= cs.RECALL_FLOOR
    assert out["merged_recall"] >= cs.RECALL_FLOOR
    assert 0.0 < out["gq0"] <= 1.0 and 0.0 < out["gq1"] <= 1.0
    assert out["bytes"] > 0 and out["save_s"] >= 0
    data = cs._shards_file(tmp)
    assert set(data["stacked"]) == {"float32", "sq8", "sq8_restored", "pq"}
    assert data["stacked"]["pq"]["n"].sum() == N_HOST


def test_phase11_ranks(world1):
    out, queries, gt, tmp = world1
    r = cs.shard_ranks_phase(tmp, queries, gt, out["merged"], "cpu",
                             batch=BATCH)
    assert r["recall"] >= cs.RECALL_FLOOR
    assert r["launches"]["beam_search"] == 0          # plain versions here
    assert set(r["stage_ms"]["float32"]) == {"search", "merge", "gather"}


def failing_rank(rank, world, tmp, cfg):
    """11c's rank, but rank 1 raises before its first collective."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return cs.shard_rank(rank, world, tmp, cfg)


def test_phase11_fails_when_a_rank_raises(world1):
    out, queries, gt, tmp = world1
    with pytest.raises(RankFailed, match="rank 1 fails on purpose"):
        cs.shard_ranks_phase(tmp, queries, gt, out["merged"], "cpu",
                             batch=BATCH, rank_fn=failing_rank)
