"""A rehearsal of ``chip_smoke.py`` phase 12 (recsys training) on the CPU:
the reduced DIN and DCN-v2 at batches of 256, every check and shape of
12a-12d kept and only the sizes cut.  The card-only pieces
(synchronisation, the profiler, CUDA events and the CUDA-graph timer) are
replaced, and every launch count the phase expects must read 0 here,
since a CPU tensor never reaches a kernel."""
import functools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from _torch_threads import _one_torch_thread  # noqa: F401

B = 256
EXPECT_LAUNCHES = cs.expect_launches


def _no_launches(kernel, got, want, what):
    assert got == 0, f"{got} {kernel} launches on the CPU"


def _untimed(fn, symbol=None, reps=0):
    fn()
    return {"device_ms": 0.0, "timed_by": "cuda_graph", "event_ms": 0.0}


def _wall_timed(fn, *args):
    import time

    t0 = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t0) * 1e3


@pytest.fixture(scope="module")
def rehearsal():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "sync", lambda: None)
        mp.setattr(cs, "idle_share", lambda fn, wall_ms, what: fn())
        mp.setattr(cs, "peak_memory", lambda reset=False: None)
        mp.setattr(cs, "expect_launches", _no_launches)
        mp.setattr(cs, "time_call", _untimed)
        mp.setattr(cs, "pass_split", lambda fn, what, reps=20: fn() and [])
        mp.setattr(cs, "_event_timed", _wall_timed)
        yield mp


@pytest.fixture(scope="module")
def tr(rehearsal):
    return cs.train_setup("cpu", reduced=True, batch=B)


@pytest.fixture(scope="module")
def counted():
    ops = cs.launch_counters()
    launches = dict.fromkeys(ops, 0)
    return launches, functools.partial(cs.counted, ops, launches)


@pytest.fixture(scope="module")
def trained(tr, counted):
    return cs.train_phase(tr, "cpu", counted[1])


def test_train_setup(tr):
    assert set(tr) == set(cs.RECSYS_ARCHS)
    din, dcn = tr["din"], tr["dcn-v2"]
    assert din["cfg"].kind == "din" and dcn["cfg"].kind == "dcn-v2"
    assert din["B"] == dcn["B"] == B
    assert len(din["host_s"]) == cs.TRAIN_STEPS
    assert set(din["batch_fn"].cache) == set(range(cs.TRAIN_STEPS))
    assert din["batch_fn"](0)["hist"].shape == (B, din["cfg"].seq_len)
    # the MLPerf split: SGD on the table, AdamW moments for the towers only
    assert set(din["state"]["embed"]) == {"count"}
    assert "table" not in din["state"]["dense"]["mu"]


def test_train_setup_reads_the_published_cell():
    from repro_torch.configs import get_arch

    for name in cs.RECSYS_ARCHS:
        assert get_arch(name).cell("train_batch")["batch"] == 65_536


def test_bag_bwd_row(tr):
    """12a at the reduced DIN's shape: the history gradient's two kernels
    (grad_w, the order and grad_table) against the plain versions, a
    second launch equal, every time and the bounds, and their rows of the
    kernels' line."""
    r = cs.bag_bwd_check(tr, "cpu")
    grad, order, whole = r["grad"], r["order"], r["whole"]
    assert grad["name"] == "bag_lookup_bwd" and grad["max_abs_err"] == 0.0
    assert order["name"] == "bag_bwd_order" and order["max_abs_err"] == 0.0
    for x in (grad, order, whole):
        assert x["bound_ms"] > 0 and x["bound_by"] == "bytes"
        assert x["t"]["timed_by"] == x["tp"]["timed_by"] == "cuda_graph"
    assert grad["tl"] is not None and order["tl"] is None
    assert grad["t_gather"]["timed_by"] == "cuda_graph"
    assert whole["bound_ms"] > grad["bound_ms"] > order["bound_ms"]
    assert grad["shape"].startswith(f"DIN history train_batch: B={B} F=10 "
                                    "E=8")
    rows = cs.kernel_rows({"bag_lookup_bwd": grad, "bag_bwd_order": order},
                          {"bag_lookup_bwd": 3, "bag_bwd_order": 3})
    for row, name in zip(rows, ("bag_lookup_bwd", "bag_bwd_order")):
        assert row["source"] == f"src/repro_torch/kernels/csrc/{name}.cu"
        assert row["replaces"] == "src/repro/models/recsys.py:212-220"
        assert os.path.exists(os.path.join(cs.ROOT, row["source"]))


def test_bag_bwd_bound_counts_what_the_data_needs():
    """The whole: ids, the valid entries' weights and G rows, g, each
    distinct row a valid id names, grad_w and the dense grad_table, each
    once; the order: ids, the valid weights, g, the distinct rows, grad_w
    and the sorted keys, positions and weights; grad_table's pass: the
    sorted entries, their G rows, g and grad_table."""
    import torch

    table = torch.zeros((10, 4))
    ids = torch.tensor([[1, 1, -1], [2, 12, -1]], dtype=torch.int32)
    g, G = torch.ones((2, 4)), torch.ones((2, 3, 4))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "time_call", _untimed)
        mp.setattr(cs, "pass_split", lambda fn, what, reps=20: [])
        r = cs.check_history_grad(table, ids, torch.ones((2, 3)), g, G, "t")
        r0 = cs.check_history_grad(table, ids, None, g, G, "t")
    valid, rows = 4, 3                                  # 1, 2 and 12 -> 9
    whole = (6 * 4 + valid * 4 + valid * 4 * 4 + 2 * 4 * 4 + rows * 4 * 4
             + 6 * 4 + 10 * 4 * 4)
    order = 6 * 4 + valid * 4 + valid * 12 + 2 * 4 * 4 + rows * 4 * 4 + 6 * 4
    grad = valid * 12 + valid * 4 * 4 + 2 * 4 * 4 + 10 * 4 * 4
    for x, want in ((r["whole"], whole), (r["order"], order),
                    (r["grad"], grad)):
        assert x["bound_ms"] == pytest.approx(want / cs.HBM_BYTES_PER_S
                                              * 1e3)
    assert r0["whole"]["bound_ms"] == pytest.approx(
        (whole - valid * 4) / cs.HBM_BYTES_PER_S * 1e3)
    assert r0["grad"]["bound_ms"] == pytest.approx(
        (grad - valid * 4) / cs.HBM_BYTES_PER_S * 1e3)
    assert "4 valid ids, 3 rows, 2 on the most named row" in \
        r["grad"]["shape"]


def test_train_phase(trained, counted):
    launches, _ = counted
    assert set(trained) == set(cs.RECSYS_ARCHS)
    for name, r in trained.items():
        assert len(r["losses"]) == cs.TRAIN_STEPS
        assert all(np.isfinite(r["losses"]))
        assert r["samples_s"] > 0 and r["flops"] > 0 and r["host_s"] > 0
        # on the CPU the kernels' chain is the plain one, and every sum is
        # added in one order
        assert r["chains"] == {"plain_plain": 0.0, "plain_kernel": 0.0}
    assert launches["bag_lookup"] == launches["bag_bwd_order"] == \
        launches["bag_lookup_bwd"] == 0


def test_chain_readings_fail_on_a_kernel_chain_that_differs(tr, trained):
    """12b's second kernel chain must end torch.equal to the first."""
    r = tr["din"]
    kept = {"params": cs._clone_tree(r["init"][0]),
            "opt": cs._clone_tree(r["init"][1])}
    with pytest.raises(AssertionError, match="second kernel chain"):
        cs.chain_readings("din", r, kept, 1)


def test_train_phase_learns(trained):
    """The planted-logit stream: the last steps' BCE below the first's."""
    for name, r in trained.items():
        assert np.mean(r["losses"][-3:]) < np.mean(r["losses"][:3]), name


def test_compare_params_names_every_leaf_off():
    import torch

    a = {"attn_mlp": {"w2": torch.full((3,), 1e-3)},
         "top_mlp": {"w0": torch.ones(2)}}
    b = {"attn_mlp": {"w2": torch.full((3,), -1e-3)},
         "top_mlp": {"w0": torch.ones(2) * (1 + 1e-6)}}
    cs._compare_params("t", a, a, rtol=0, atol=0)
    with pytest.raises(AssertionError, match=r"\('attn_mlp', 'w2'\)"):
        cs._compare_params("t", a, b, rtol=1e-4, atol=1e-6)
    b["attn_mlp"]["w2"] = a["attn_mlp"]["w2"].clone()
    cs._compare_params("t", a, b, rtol=1e-4, atol=1e-6)


def test_loop_phase(tr, trained, counted, tmp_path):
    """12c: the failure, the resume from step 5 and its torch.equal end;
    DCN-v2's whole state saved and restored."""
    out = cs.loop_phase(tr, trained, str(tmp_path), counted[1])
    assert out["ckpt_bytes"] > 0 and out["save_s"] > 0
    assert counted[0]["bag_lookup_bwd"] == 0


def test_loop_phase_fails_on_a_resume_that_differs(tr, trained, tmp_path):
    """A resumed run that does not end where the uninterrupted one did
    fails 12c."""
    import torch

    other = {k: dict(v) for k, v in trained.items()}
    params = dict(other["din"]["params"])
    params["table"] = params["table"] + 1e-7
    other["din"]["params"] = params
    with pytest.raises(AssertionError, match="differs"):
        cs.loop_phase(tr, other, str(tmp_path))
    assert not torch.equal(params["table"], trained["din"]["params"]["table"])


def test_train_launcher_phase(tmp_path):
    """12d on the CPU: the injected failure's exit, the resume and the
    final loss below the first (30 steps, the failure after step 12)."""
    out = cs.train_launcher_phase("cpu", str(tmp_path), steps=30,
                                  fail_at=12)
    assert out["final"] < out["first"] and out["seconds"] > 0


def test_training_phase_end_to_end(rehearsal, counted):
    """The function main() calls: 12a-12d in order, in a temporary
    directory; its numbers come back without the parameters."""
    out = cs.training_phase("cpu", counted[1], reduced=True, batch=B,
                            steps=30, fail_at=12)
    assert out["bwd"]["grad"]["name"] == "bag_lookup_bwd"
    assert out["bwd"]["order"]["name"] == "bag_bwd_order"
    assert set(out["trained"]) == set(cs.RECSYS_ARCHS)
    assert "params" not in out["trained"]["din"]
    assert out["loop"]["ckpt_bytes"] > 0
    assert out["launcher"]["final"] < out["launcher"]["first"]


def test_main_runs_phase_12_after_phase_8():
    """main() runs phase 12 right after phase 8 and puts its row in the
    kernels' line; the counters and the plain-version switch know the
    backward."""
    import inspect

    src = inspect.getsource(cs.main)
    order = [src.index(s) for s in (
        "recsys_phase(", 'training_phase(device, count)["bwd"]',
        'checks["bag_bwd_order"]', 'checks["bag_lookup_bwd"]',
        "build_phase(", 'json.dumps({"kernels": kernel_rows(')]
    assert order == sorted(order)
    assert cs.launch_counters()["bag_lookup_bwd"][1] == "launches_bwd"
    assert cs.launch_counters()["bag_bwd_order"][1] == "launches_order"
    from repro_torch.kernels.bag_lookup import ops

    for name in ("bag_lookup_bwd", "bwd_order", "table_grad"):
        real = getattr(ops, name)
        with cs.plain_kernels():
            assert getattr(ops, name) is not real
            assert getattr(ops, name).keywords == {"impl": "ref"}
        assert getattr(ops, name) is real
