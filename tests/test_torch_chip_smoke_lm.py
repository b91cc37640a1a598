"""A rehearsal of ``chip_smoke.py`` phase 13 (LM serving) on the CPU: the
functions of 13a-13d at the reduced gemma3 and qwen3 configs and small
sizes, every check kept and only the sizes cut; 13d's subprocess runs the
reduced qwen3 on the CPU.  The card-only pieces (synchronisation, the
profiler, CUDA events) are replaced; so is the child process of each
served model, whose code runs in this process, where those replacements
hold."""
import contextlib
import dataclasses
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


def _wall_timed(fn, *args):
    import time

    t0 = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t0) * 1e3


_RUN = subprocess.run


def _run_here(cmd, **kw):
    """``subprocess.run`` of ``python -c CODE``, run in this process."""
    if cmd[:2] != [sys.executable, "-c"]:
        return _RUN(cmd, **kw)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exec(cmd[2], {})
    return subprocess.CompletedProcess(cmd, 0, out.getvalue(), "")


@pytest.fixture(scope="module")
def rehearsal():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs.subprocess, "run", _run_here)
        mp.setattr(cs, "sync", lambda: None)
        mp.setattr(cs, "idle_share", lambda fn, wall_ms, what: fn())
        mp.setattr(cs, "peak_memory", lambda reset=False: None)
        mp.setattr(cs, "_event_timed", _wall_timed)
        yield mp


def _reduced(arch, **kw):
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch).reduced(), **kw)


# the two served specs of LM_SERVED at reduced sizes: gemma3's 1:1 local /
# global pattern with a window of 8, qwen3's 4 experts top-2; prompts past
# the reduced q_chunk of 32 and the window
SERVED = (
    dict(arch="gemma3-12b", reduced=True, B=1, S=40, check=dict(B=2, S=21)),
    dict(arch="qwen3-moe-30b-a3b", reduced=True, layers=2, B=4, S=36,
         check=dict(B=2, S=17, capacity_factor=2.0)),
)


@pytest.fixture(scope="module")
def served(rehearsal):
    return {s["arch"]: cs.lm_setup(s["arch"], "cpu", layers=s.get("layers"),
                                   cfg=_reduced(s["arch"])) for s in SERVED}


def test_served_specs_are_the_published_cells():
    from repro_torch.configs import get_arch
    from repro_torch.models.moe import _capacity

    gemma, qwen = cs.LM_SERVED
    g = get_arch("gemma3-12b")
    assert gemma["S"] == g.cell("prefill_32k")["seq_len"] == \
        g.cell("decode_32k")["seq_len"]
    assert gemma["layers"] is None and gemma["B"] == 1
    assert gemma["check"]["S"] > 2 * g.model.sliding_window
    q = get_arch("qwen3-moe-30b-a3b").model
    assert qwen["layers"] == 16 and (qwen["B"], qwen["S"]) == (4, 4096)
    assert _capacity(qwen["B"] * qwen["S"], q.moe) == 1_288
    cf = qwen["check"]["capacity_factor"]
    assert cf == q.moe.n_experts / q.moe.top_k
    T = qwen["check"]["B"] * qwen["check"]["S"]
    assert _capacity(T, dataclasses.replace(q.moe, capacity_factor=cf)) >= T
    assert cs.LAUNCH_LM["arch"] == "qwen3-moe-30b-a3b"


def test_lm_setup_counts_the_parameters(served):
    for arch, lm in served.items():
        assert lm["param_bytes"] == 4 * lm["cfg"].param_count
        assert lm["allocated"] is None and lm["init_s"] > 0


def test_lm_setup_cuts_layers(rehearsal):
    lm = cs.lm_setup("qwen3-moe-30b-a3b", "cpu", layers=1,
                     cfg=_reduced("qwen3-moe-30b-a3b"))
    assert lm["cfg"].n_layers == 1
    assert lm["model"].params()["layers"]["wq"].shape[0] == 1


@pytest.mark.parametrize("spec", SERVED, ids=[s["arch"] for s in SERVED])
def test_lm_serve_phase(served, spec):
    r = cs.lm_serve_phase(served[spec["arch"]], spec["B"], spec["S"], "cpu",
                          steps=4)
    assert r["prefill_s"] > 0 and r["tokens_s"] > 0 and r["mfu"] > 0
    assert r["decode_ms"] > 0 and r["bound_ms"] > 0
    cfg = served[spec["arch"]]["cfg"]
    # 1 global layer of S + 4 slots and 1 ring of 8 (gemma); 2 global
    glob = cfg.is_global_layer()
    slots = sum(spec["S"] + 4 if g else min(cfg.sliding_window, spec["S"] + 4)
                for g in glob)
    assert r["kv_bytes"] == 2 * spec["B"] * slots * cfg.n_kv_heads * \
        cfg.head_dim * 2


def test_lm_serve_phase_fails_on_a_non_finite_logit(served):
    lm = dict(served["gemma3-12b"])
    p = {k: (dict(v) if isinstance(v, dict) else v)
         for k, v in lm["model"].params().items()}
    p["final_norm"] = torch.full_like(p["final_norm"], float("nan"))
    from repro_torch.models.transformer import TransformerModel

    lm["model"] = TransformerModel(lm["cfg"], p)
    with pytest.raises(AssertionError, match="non-finite"):
        cs.lm_serve_phase(lm, 1, 8, "cpu", steps=2)


@pytest.mark.parametrize("spec", SERVED, ids=[s["arch"] for s in SERVED])
def test_lm_readings(served, spec):
    r = cs.lm_readings(served[spec["arch"]], spec["B"], spec["S"], "cpu")
    assert r["attention_ms"] > 0 and r["cast_ms"] > 0
    assert ("dispatch_ms" in r) == (spec["arch"] == "qwen3-moe-30b-a3b")


@pytest.mark.parametrize("spec", SERVED, ids=[s["arch"] for s in SERVED])
def test_lm_consistency(served, spec):
    out = cs.lm_consistency(served[spec["arch"]], "cpu", **spec["check"])
    assert set(out) == {"float32", "bfloat16", "bfloat16_own",
                        "bfloat16_past"}
    assert out["float32"] <= 1e-3
    assert out["bfloat16"] <= out["bfloat16_own"]
    assert out["bfloat16_own"] > 0                  # bfloat16 rounds


def test_lm_consistency_fails_when_the_serve_path_parts(served):
    """A decode step that reads a wrong position parts from the forward
    by far more than bfloat16 rounds: the float32 check fails."""
    from repro_torch.models import transformer as TT

    real = TT._ring_slot_positions
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TT, "_ring_slot_positions",
                   lambda cl, nxt, device=None: real(cl, nxt - 1, device))
        with pytest.raises(AssertionError, match="float32 forward vs"):
            cs.lm_consistency(served["gemma3-12b"], "cpu", B=2, S=21)


def test_routes_apart_reads_tokens_sequence_major():
    a = [(np.array([[0, 1], [0, 2], [1, 2], [0, 1]]),
          np.array([0.5, 0.01, 0.3, 0.2]))]
    b = [(np.array([[0, 1], [1, 2], [1, 2], [0, 1]]),
          np.array([0.5, 0.02, 0.3, 0.2]))]
    other, worst = cs.routes_apart(a, b, 2)
    assert other.tolist() == [[False, True], [False, False]]
    assert worst == pytest.approx(0.02)
    assert cs._reached(other, 2, 2).tolist() == [[False, True],
                                                 [False, False]]
    assert cs.routes_apart([], [], 2) == (None, 0.0)


def test_join_layers_puts_decode_steps_after_the_prefill():
    """Two layers, B=2: a prefill of 2 positions, then one decode step;
    each layer's tokens come out as (sequence, position)."""
    K = 1
    pre = [(np.array([[10], [11], [20], [21]]), np.zeros(4)),
           (np.array([[110], [111], [120], [121]]), np.zeros(4))]
    dec = [(np.array([[12], [22]]), np.ones(2)),
           (np.array([[112], [122]]), np.ones(2))]
    j = cs._join_layers(2, 2, pre, dec)
    assert j[0][0].reshape(2, 3, K)[..., 0].tolist() == [[10, 11, 12],
                                                         [20, 21, 22]]
    assert j[1][1].reshape(2, 3).tolist() == [[0, 0, 1], [0, 0, 1]]
    # moe_groups=2: two calls a layer, one sequence each
    grouped = [(np.array([[10], [11]]), np.zeros(2)),
               (np.array([[20], [21]]), np.zeros(2))]
    assert cs._join_layers(1, 2, grouped)[0][0][:, 0].tolist() == \
        [10, 11, 20, 21]


def test_allclose_names_what_is_off():
    a = torch.zeros(2, 3)
    b = a.clone()
    b[1, 2] = 1.0
    with pytest.raises(AssertionError, match="1 of 6 entries off"):
        cs._allclose("t", a, b, (1e-4, 1e-5))
    assert cs._allclose("t", a, b, (1e-4, 1e-5),
                        np.array([True, False])) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mixtral-8x22b"])
def test_lm_reduced_check(arch, dtype, rehearsal):
    """13c on the CPU against itself: every difference 0."""
    r = cs.lm_reduced_check(arch, "cpu", dtype=dtype)
    assert r == {"worst": 0.0, "near": []}


def test_lm_reduced_check_with_moe_groups(rehearsal):
    r = cs.lm_reduced_check("qwen3-moe-30b-a3b", "cpu", dtype="float32",
                            moe_groups=2)
    assert r["worst"] == 0.0


def test_served_in_child_relays_the_log_and_the_numbers(rehearsal, capsys):
    spec = dict(SERVED[0], S=12, check=dict(B=2, S=9))
    r = cs.served_in_child(spec, "cpu", steps=2)
    assert r["consistency"]["float32"] <= 1e-3 and r["kv_bytes"] > 0
    out = capsys.readouterr().out
    assert "phase13 gemma3-12b prefill B=1 S=12" in out
    assert cs.RESULT not in out


def test_served_in_child_fails_with_the_child(rehearsal):
    def failed(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 1, "phase13 x\n", "boom")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs.subprocess, "run", failed)
        with pytest.raises(AssertionError, match="exited 1: boom"):
            cs.served_in_child(SERVED[0], "cpu")


def test_lm_phase_end_to_end(rehearsal, tmp_path):
    """The function main() calls: 13a-13b at the rehearsal's sizes, 13c
    over the five reduced configs and qwen3's groups, 13d's subprocess on
    the CPU as LAUNCH_LM has it (60 steps, the failure after step 30)."""
    served = tuple(dict(s, B=1, S=12, check=dict(s["check"], S=9))
                   for s in SERVED)
    with pytest.MonkeyPatch.context() as mp:
        # the launcher's subprocesses on one thread, as this module's work:
        # beside the other test workers a thread a core stalls them
        mp.setenv("OMP_NUM_THREADS", "1")
        out = cs.lm_phase("cpu", served=served, steps=2, tmp=str(tmp_path))
    assert set(out) == {"gemma3-12b", "qwen3-moe-30b-a3b", "reduced",
                        "launcher"}
    assert len(out["reduced"]) == 12
    assert all(r["worst"] == 0.0 for r in out["reduced"])
    assert out["launcher"]["final"] < out["launcher"]["first"]


def test_main_runs_phase_13_first():
    """main() runs phase 13 right after the kernels' build, before phase 2
    holds anything on the card, and the kernels' line after every phase."""
    import inspect

    src = inspect.getsource(cs.main)
    order = [src.index(s) for s in (
        "_build.build_all()", "lm_phase(device)", "phase2(device",
        'training_phase(device, count)["bwd"]',
        'json.dumps({"kernels": kernel_rows(')]
    assert order == sorted(order)
