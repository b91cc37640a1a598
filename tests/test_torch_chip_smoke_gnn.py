"""A rehearsal of ``chip_smoke.py`` phase 14 (the EGNN family) on the CPU:
14a-14e through ``gnn_in_child`` at small graphs and the cells' widths,
every check kept and only the sizes cut (minibatch_lg's graph at 3,000
nodes and 32 seeds, ogb_products' at 4,000 nodes and 50,000 edges; the
full_graph_sm, molecule and halo pieces at their cells' sizes).  The
card-only pieces (synchronisation, the profiler, CUDA events, peak
memory) are replaced; so is the child process, whose code runs in this
process, where those replacements hold.  14c's launcher subprocess and
14d's four gloo ranks run as on the card, on the CPU."""
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: F401

_RUN = subprocess.run
SIZES = dict(minibatch=dict(n_nodes=3_000, avg_degree=12, batch_nodes=32),
             products=dict(n_nodes=4_000, n_edges=50_000),
             halo=dict(reps=1))


def _wall_timed(fn, *args):
    import time

    t0 = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t0) * 1e3


def _run_here(cmd, **kw):
    """``subprocess.run`` of ``python -c CODE``, run in this process."""
    if cmd[:2] != [sys.executable, "-c"]:
        return _RUN(cmd, **kw)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exec(cmd[2], {})
    return subprocess.CompletedProcess(cmd, 0, out.getvalue(), "")


@pytest.fixture(scope="module")
def phase14():
    logged = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs.subprocess, "run", _run_here)
        mp.setattr(cs, "sync", lambda: None)
        mp.setattr(cs, "idle_share", lambda fn, wall_ms, what: fn())
        mp.setattr(cs, "peak_memory", lambda reset=False: None)
        mp.setattr(cs, "_event_timed", _wall_timed)
        mp.setattr(cs, "log", lambda *a: logged.append(" ".join(map(str, a))))
        out = cs.gnn_in_child("cpu", **SIZES)
    return out, logged


def test_constants_are_the_cells():
    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import subgraph_shapes

    spec = get_arch("egnn")
    cell = spec.cell("minibatch_lg")
    assert 232_965 * cs.REDDIT_DEGREE >= cell["n_edges"]
    assert subgraph_shapes(cell["batch_nodes"], cell["fanouts"]) == \
        (169_984, 168_960)
    assert cs.GNN_FAIL_AT // cs.GNN_CKPT_EVERY * cs.GNN_CKPT_EVERY == 5
    assert cs.GNN_STEPS == 12 and cs.HALO_MESH == (2, 2)
    assert spec.cell("full_graph_sm")["n_nodes"] % 4 == 0
    assert cs.LAUNCH_GNN["arch"] == "egnn"


def test_phase14_readings(phase14):
    out, logged = phase14
    a = out["14a"]
    assert len(a["losses"]) == cs.GNN_STEPS
    assert all(np.isfinite(a["losses"]))
    assert a["step_ms"] > 0 and a["seeds_s"] > 0 and a["sampler_ms"] > 0
    assert a["peak"] is None and a["flops"] > 0
    assert out["14c"]["latest"] == 5
    assert out["14c"]["launcher"]["final"] < out["14c"]["launcher"]["first"]
    b = out["14b"]
    for k in ("full_graph_sm", "molecule"):
        assert b[k]["step_ms"] > 0
    # on the CPU both sides of the comparison run the same code
    for case in b["card_vs_cpu"].values():
        for dt in ("float32", "bfloat16"):
            assert set(case[dt]) == {"logits", "coords", "loss", "grads"}
            assert all(v == 0.0 for v in case[dt].values())
    d = out["14d"]
    assert d["loss"] == pytest.approx(d["want"], rel=1e-5)
    assert len(d["step_ms"]) == len(d["gather_ms"]) == 4
    e = out["14e"]
    assert (e["n_nodes"], e["n_edges"]) == (4_000, 50_000)
    assert e["forward_s"] > 0 and e["embeddings_s"] > 0 and e["flops"] > 0
    text = "\n".join(logged)
    for tag in ("phase14a sampler", "phase14a minibatch_lg train",
                "phase14c determinism", "phase14c egnn train_loop",
                "phase14c launch.train --arch egnn", "phase14b full_graph_sm",
                "phase14b molecule", "phase14d world size 1",
                "phase14d 4 gloo ranks", "phase14e ogb_products",
                "kernel launches"):
        assert tag in text, tag


def test_power_law_on_device_draws_the_distribution():
    """The card's generator: sorted sources with no self-loop, CSR rows
    that hold them, an exact edge count where asked, and a heavy head as
    the numpy generator's Pareto weights give."""
    g, src = cs.power_law_on_device(2_000, 10, "cpu", seed=3, n_edges=19_000)
    assert g.n_edges == 19_000 and src.shape[0] == 19_000
    assert bool((src[1:] >= src[:-1]).all())
    assert int(g.row_ptr[-1]) == 19_000 and int(g.deg.sum()) == 19_000
    rows = torch.repeat_interleave(torch.arange(2_000), g.deg)
    assert torch.equal(rows, src)
    assert not bool((g.col_idx.long() == src).any())
    from repro_torch.data.graphs import random_power_law_graph

    host = random_power_law_graph(2_000, 10, seed=3)
    top = np.sort(host.degrees())[-20:].sum() / host.n_edges
    mine = float(torch.sort(g.deg)[0][-20:].sum()) / g.n_edges
    assert 0.2 * top < mine < 5 * top


def test_halo_rank_counts_no_kernel_launch(phase14):
    out, logged = phase14
    assert "phase14 launched" not in "\n".join(logged)


def test_main_runs_phase_14_after_phase_13():
    """main() runs phase 14 in its child right after phase 13's children
    and before phase 2, and the docstring lists 14a-14e and the kernels'
    line as phase 15."""
    import inspect

    src = inspect.getsource(cs.main)
    order = [src.index(s) for s in (
        "_build.build_all()", "lm_phase(device)", "gnn_in_child(device)",
        "phase2(device", 'json.dumps({"kernels": kernel_rows(')]
    assert order == sorted(order)
    doc = " ".join(cs.__doc__.split())
    for part in ("14. (right after phase 13's children", "14a. minibatch_lg",
                 "14b. full_graph_sm", "14c. one minibatch_lg batch",
                 "14d. the halo loss", "14e. ogb_products",
                 "15. the kernels' JSON line"):
        assert part in doc, part
