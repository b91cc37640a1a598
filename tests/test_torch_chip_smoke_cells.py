"""A rehearsal of ``chip_smoke.py`` phase 15 (the cell builder) on the
CPU: 15a builds every cell on the world-size-1 gloo mesh with its
placements, 15b runs the deg-ann cells' fn over 4,096 random vectors and
a batch of 32 (the card's: 2^24 and 4,096) with every lane's kernel-route
checks taking the plain versions, 15c runs the serve and train cells'
fn at the reduced widths, each torch.equal to the unsharded function.
The card-only pieces (synchronisation, peak memory, CUDA events) are
replaced, and every launch count must read 0 here."""
import functools
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: F401

N, BATCH = 4096, 32


def _wall_timed(fn, *args):
    import time

    t0 = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t0) * 1e3


@pytest.fixture(scope="module")
def phase15():
    ops = cs.launch_counters()
    launches = dict.fromkeys(ops, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "sync", lambda: None)
        mp.setattr(cs, "peak_memory", lambda reset=False: None if reset
                   else 0)
        mp.setattr(cs, "_event_timed", _wall_timed)
        out = cs.cells_phase(
            "cpu", functools.partial(cs.counted, ops, launches),
            deg=dict(n=N, batch=BATCH, reps=1), reduced=True)
    return out, launches


def test_cells_built(phase15):
    """15a: every cell of the registry (less the skipped), the deg-ann
    shapes and the debug mesh test's variants, each with its bytes."""
    out, _ = phase15
    built = out["built"]
    from repro_torch.configs import get_arch

    skipped = {(a, s, v) for a, s, v in cs.cell_list()
               if a != "deg-ann" and s in get_arch(a).skip}
    assert set(built) == set(cs.cell_list()) - skipped
    assert len(skipped) == 3
    for key in cs.CELL_VARIANTS:
        assert key in built
    din = built[("din", "train_batch", "")]
    assert din["kind"] == "recsys_train" and len(din["bytes"]) == 3
    # the deg-ann cells at world size 1: one shard of 2^24 rows
    search = built[("deg-ann", "search_16m", "")]["bytes"]
    assert search[:2] == [(1 << 24) * 30 * 4, (1 << 24) * 128 * 4]


def test_deg_cells_ran(phase15):
    out, _ = phase15
    assert list(out["deg"]) == ["search_16m", "explore_16m",
                                "build_wave_16m", "search_16m bf16vecs"]
    for what, r in out["deg"].items():
        assert r["hops_mean"] > 0 and r["evals_max"] > 0, what
        assert r["bound_ms"] > 0 and r["qps"] > 0
        # on the CPU the kernel route is the plain version itself
        assert all(r["same"].values()) and r["max_abs_err"] == 0.0
    assert out["deg"]["search_16m bf16vecs"]["rows"] == "bfloat16"
    assert out["deg"]["search_16m"]["rows"] == "float32"


def test_serve_and_train_cells_ran(phase15):
    out, _ = phase15
    assert set(out["run"]) == {"din serve_p99", "dcn-v2 serve_p99"}


def test_no_launch_on_the_cpu(phase15):
    _, launches = phase15
    assert not any(launches.values()), launches


def test_hamiltonian_adjacency_is_regular():
    import torch

    gen = torch.Generator().manual_seed(0)
    adj = cs.hamiltonian_adjacency(1000, 30, gen, "cpu")
    assert adj.shape == (1000, 30) and adj.dtype == torch.int32
    # each cycle's successor and predecessor columns invert each other
    for c in range(15):
        succ, pred = adj[:, 2 * c].long(), adj[:, 2 * c + 1].long()
        assert torch.equal(pred[succ], torch.arange(1000))
    # every vertex is named 30 times
    assert torch.equal(torch.bincount(adj.flatten().long(), minlength=1000),
                       torch.full((1000,), 30))


def test_deg_bound_counts_half_rows():
    """15b's bound is phase 2's: the distinct rows the call reads, at the
    rows' own bytes, so bfloat16 rows bound below float32 ones."""
    import torch
    from repro_torch.core import beam
    from repro_torch.core.graph import DEGraph
    from repro_torch.quant.store import VectorStore

    gen = torch.Generator().manual_seed(0)
    n, B, L = 1000, 8, 64
    adj = cs.hamiltonian_adjacency(n, 30, gen, "cpu")
    vecs = torch.randn((n, 128), generator=gen)
    q = torch.randn((B, 128), generator=gen)
    graph = DEGraph(adjacency=adj, weights=torch.zeros(adj.shape), n=n)
    excl = torch.full((B, 1), cs.INVALID, dtype=torch.int32)
    seeds = torch.zeros((B, 1), dtype=torch.int32)
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "sync", lambda: None)
        for dt in (torch.float32, torch.bfloat16):
            store = VectorStore(data=vecs.to(dt))
            st = beam.init(store, q, seeds, excl, n, beam_width=L,
                           metric="l2")
            got[dt] = cs.hold_whole_search(str(dt), graph, store, q, excl,
                                           st, k=10, eps=cs.DEG_EPS)
    full, half = got[torch.float32], got[torch.bfloat16]
    assert full["bound_by"] == half["bound_by"] == "bytes"
    assert 0 < half["bound_ms"] < full["bound_ms"]
    # no more rows than the lanes scored, and each read once
    assert 0 < full["rows_read"] <= full["evals"] + B
    assert full["agree"] == 1.0 and all(full["same"].values())


def test_memory_left_fails_on_reserved_beyond_allocated():
    """The check after phase 12 fails on reserved bytes that empty_cache
    could not return (a graph pool: 49,471,815,680 reserved for about
    0.58 GB allocated), and passes a run that returned them."""
    before = {"allocated": 545_259_520, "reserved": 587_202_560}
    assert cs.memory_left(before, dict(before)) is None
    pool = {"allocated": 545_259_520, "reserved": 49_471_815_680}
    left = cs.memory_left(before, pool)
    assert "more reserved" in left and "beyond the allocated" in left
    grown = {"allocated": before["allocated"] + (2 << 30),
             "reserved": before["reserved"] + (2 << 30)}
    assert "more allocated" in cs.memory_left(before, grown)


def test_memory_check_constants():
    assert cs.MEMORY_SLACK == 1 << 30
    assert cs.CELLS_MESH == (1, 1)


def test_main_runs_phase_15_after_phase_12_in_the_parent():
    """main() checks the card's memory across phases 8-12, then runs phase
    15 in this process before the build; the docstring lists 15a-15c."""
    import inspect

    src = inspect.getsource(cs.main)
    order = [src.index(s) for s in (
        'card_memory("before phase 8")', "recsys_setup(device)",
        'training_phase(device, count)["bwd"]',
        'card_memory("after phase 12")', "memory_left(before8, after12)",
        "cells_phase(device, count)", "build_phase(",
        'json.dumps({"kernels": kernel_rows(')]
    assert order == sorted(order)
    doc = " ".join(cs.__doc__.split())
    for part in ("15. (in this process, right after phase 12",
                 "15a. every cell of the registry", "15b. the deg-ann cells",
                 "15c. cells through their fn"):
        assert part in doc, part
