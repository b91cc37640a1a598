"""The port's resilience layer — admission control, the degradation
ladder, request validation, fault injection and the watchdog/supervisor
of its AsyncQueryEngine — the twin of the JAX package's
``tests/test_resilience.py``.

The contract under test: every ``submit`` ends in exactly one of a
result, a typed rejection (``OverloadError`` /
``RequestValidationError``), or a typed crash error
(``EngineCrashedError``) — never a hang, never silent garbage.  The
ladder's rungs, the validation verdicts and the fault plans' schedules
are also held equal to the JAX package's.
"""
import json
import time
import urllib.request

import numpy as np
import pytest

from repro_torch.core.build import DEGParams, build_deg
from repro_torch.resilience import (EngineCrashedError, FaultInjected, FaultPlan,
                              OverloadError, RequestValidationError,
                              clock_skew, validate_query)
from repro_torch.resilience.degrade import (DegradePolicy, LadderController,
                                      build_ladder)
from repro_torch.serving.async_engine import AsyncQueryEngine
from repro_torch.serving.buckets import ProgramConfig
from repro_torch.serving.scheduler import AdmissionQueue, CancelledError
from _torch_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(400, 8)).astype(np.float32)
    return build_deg(vecs, DEGParams(degree=8, k_ext=16), wave_size=8,
                     device="cpu"), vecs


# -- parity with the JAX package ---------------------------------------------

@pytest.mark.parametrize("codec, policy", [
    ("float32", {}), ("float32", {"max_rung": 1}),
    ("float32", {"last_rung_rerank": None}), ("sq8", {}),
    ("float32", {"beam_frac": 0.5, "hop_frac": 0.25}),
])
@pytest.mark.parametrize("beam, k, degree", [(64, 10, 16), (None, 10, 20),
                                             (None, 5, 8)])
def test_ladder_rungs_match_jax(codec, policy, beam, k, degree):
    from repro.resilience.degrade import DegradePolicy as JPolicy
    from repro.resilience.degrade import build_ladder as j_build_ladder
    from repro.serving.buckets import ProgramConfig as JProgramConfig

    kw = dict(k=k, eps=0.1, beam_width=beam, codec=codec,
              rerank_k=40 if codec != "float32" else None, expand_width=1,
              visited_size=256)
    got = build_ladder(ProgramConfig(hop_backend="composed", **kw), degree,
                       DegradePolicy(**policy))
    want = j_build_ladder(JProgramConfig(hop_backend="jnp", **kw), degree,
                          JPolicy(**policy))
    assert [r.name for r in got] == [r.name for r in want]
    for a, b in zip(got, want):
        assert a.hop_budget == b.hop_budget
        for f in ("k", "eps", "beam_width", "codec", "rerank_k",
                  "expand_width", "visited_size"):
            assert getattr(a.cfg, f) == getattr(b.cfg, f), f


@pytest.mark.parametrize("backlogs", [
    [8, 9, 4, 8, 8, 8, 0, 0, 0, 0, 0],
    [16] * 12 + [0] * 20,
    [3, 5, 7, 9, 11, 13, 15, 1, 1, 1, 1, 1, 1, 1, 1, 1],
])
def test_ladder_controller_matches_jax(backlogs):
    from repro.resilience.degrade import DegradePolicy as JPolicy
    from repro.resilience.degrade import LadderController as JController

    moves, jmoves = [], []
    ctl = LadderController(4, 16, DegradePolicy(down_after=3, up_after=4),
                           on_change=lambda *m: moves.append(m))
    jctl = JController(4, 16, JPolicy(down_after=3, up_after=4),
                       on_change=lambda *m: jmoves.append(m))
    assert [ctl.observe(b) for b in backlogs] == \
        [jctl.observe(b) for b in backlogs]
    assert moves == jmoves


def test_validation_and_fault_plans_match_jax():
    from repro.resilience import FaultInjected as JFaultInjected
    from repro.resilience import FaultPlan as JFaultPlan
    from repro.resilience import RequestValidationError as JValidationError
    from repro.resilience import validate_query as j_validate_query

    cases = [[1.0] * 8, np.arange(8), np.ones((1, 8)), np.ones(7),
             np.full(8, np.nan), np.array([1 + 2j] * 8),
             np.float64(1e39) * np.ones(8)]
    for c in cases:
        try:
            want = j_validate_query(c, 8)
        except JValidationError:
            want = None
        try:
            got = validate_query(c, 8)
        except RequestValidationError:
            got = None
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)

    def fired(plan, inj):
        hits = []
        for i in range(200):
            try:
                plan.fire("p")
            except inj:
                hits.append(i)
        return hits

    spec = "p:kill%0.3*5"
    assert fired(FaultPlan.parse(spec, seed=7), FaultInjected) == \
        fired(JFaultPlan.parse(spec, seed=7), JFaultInjected)


# -- request validation ----------------------------------------------------

def test_validate_query_accepts_and_normalizes():
    out = validate_query([1.0] * 8, 8)
    assert out.dtype == np.float32 and out.shape == (8,)
    assert out.flags["C_CONTIGUOUS"]
    # float64 and int inputs downcast cleanly
    assert validate_query(np.arange(8, dtype=np.int64), 8).dtype == np.float32
    # (1, d) squeezes to (d,)
    assert validate_query(np.ones((1, 8)), 8).shape == (8,)


@pytest.mark.parametrize("bad", [
    np.full(8, np.nan, np.float32),
    np.full(8, np.inf, np.float32),
    np.ones(7, np.float32),                  # wrong dim
    np.ones((2, 8), np.float32),             # a batch, not one query
    np.array([1 + 2j] * 8),                  # complex
    np.array(["a"] * 8, dtype=object),       # non-numeric
    np.float64(1e39) * np.ones(8),           # finite f64 -> inf in f32
])
def test_validate_query_rejects(bad):
    with pytest.raises(RequestValidationError):
        validate_query(bad, 8)


def test_submit_validation_typed_and_counted(index):
    from repro_torch.obs import MetricsRegistry

    idx, vecs = index
    reg = MetricsRegistry()
    with AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=None,
                          metrics=reg) as eng:
        with pytest.raises(RequestValidationError):
            eng.submit(np.full(8, np.nan, np.float32))
        with pytest.raises(RequestValidationError):
            eng.submit(vecs[0][:5])
        ids, _ = eng.submit(vecs[0]).result(120.0)   # engine still serves
        assert (ids >= 0).any()
    assert eng.stats.invalid == 2
    assert reg.counter("serving_invalid_requests_total").value == 2


# -- NaN blast radius (satellite: poison-query confinement) ----------------

def test_nan_blast_radius_raw_batch(index):
    """Characterization of the raw dispatch path: a NaN lane does NOT
    poison its batchmates (per-lane bit-identity holds), but the NaN
    lane itself silently returns -1/inf garbage — which is exactly why
    validation must reject it at submit, not let it reach a device
    batch."""
    from repro_torch.serving.engine import QueryEngine

    idx, vecs = index
    rng = np.random.default_rng(1)
    qs = vecs[:8] + 0.01 * rng.normal(size=(8, 8)).astype(np.float32)
    eng = QueryEngine(idx, k=5, max_batch=16)
    clean_ids, clean_d = eng.search(qs)
    mixed = np.vstack([qs, np.full((1, 8), np.nan, np.float32)])
    mix_ids, mix_d = eng.search(mixed)
    np.testing.assert_array_equal(mix_ids[:8], clean_ids)
    np.testing.assert_array_equal(mix_d[:8], clean_d)
    assert (mix_ids[8] == -1).all()          # the silent-garbage mode
    assert np.isinf(mix_d[8]).all()


def test_nan_confined_by_validation(index):
    """Engine-level pin: with validation on, poison submissions raise and
    the clean requests' results are bit-identical to a clean-only run —
    the poison never influences batch composition semantics."""
    idx, vecs = index
    rng = np.random.default_rng(2)
    qs = vecs[:12] + 0.01 * rng.normal(size=(12, 8)).astype(np.float32)

    with AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=None) as eng:
        ref = [eng.submit(q).result(120.0) for q in qs]
    with AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=None) as eng:
        got, rejected = [], 0
        for i, q in enumerate(qs):
            if i % 3 == 1:                  # interleave poison attempts
                try:
                    eng.submit(np.full(8, np.nan, np.float32))
                except RequestValidationError:
                    rejected += 1
            got.append(eng.submit(q).result(120.0))
    assert rejected == 4
    for (ri, rd), (gi, gd) in zip(ref, got):
        np.testing.assert_array_equal(ri, gi)
        np.testing.assert_array_equal(rd, gd)


# -- bounded admission ------------------------------------------------------

def test_admission_reject_policy():
    q = AdmissionQueue(capacity=2, shed_policy="reject")
    q.push(np.zeros(4))
    q.push(np.zeros(4))
    with pytest.raises(OverloadError) as ei:
        q.push(np.zeros(4))
    assert ei.value.shed_at == "submit"
    assert ei.value.depth == 2 and ei.value.capacity == 2
    assert len(q) == 2                       # queued work undisturbed


def test_admission_reject_ignores_dead_slots():
    """Cancelled requests occupy deque slots but are not live — capacity
    counts live requests, so a full-of-corpses queue still admits."""
    q = AdmissionQueue(capacity=2, shed_policy="reject")
    a = q.push(np.zeros(4))
    q.push(np.zeros(4))
    assert a.cancel()
    q.push(np.zeros(4))                      # a's slot was dead: admitted
    with pytest.raises(OverloadError):
        q.push(np.zeros(4))


def test_admission_drop_policy_evicts_most_doomed():
    shed = []
    q = AdmissionQueue(capacity=2, shed_policy="drop",
                       on_shed=lambda r: shed.append(r))
    a = q.push(np.zeros(4), deadline=1.0)
    b = q.push(np.zeros(4), deadline=2.0)
    c = q.push(np.zeros(4), deadline=3.0)    # evicts a (earliest deadline)
    assert [r.result for r in shed] == [a]
    with pytest.raises(OverloadError) as ei:
        a.result(0.1)
    assert ei.value.shed_at == "queue"
    # the incoming request being the most doomed is rejected at the door
    with pytest.raises(OverloadError) as ei:
        q.push(np.zeros(4), deadline=0.5)
    assert ei.value.shed_at == "submit"
    assert b._state == "pending" and c._state == "pending"
    # survivors dispatch in FIFO order, corpses discarded
    assert [r.result for r in q.pop_ready(10)] == [b, c]


def test_admission_drop_without_deadlines_degenerates_to_reject():
    q = AdmissionQueue(capacity=1, shed_policy="drop")
    a = q.push(np.zeros(4))
    with pytest.raises(OverloadError) as ei:
        q.push(np.zeros(4))
    assert ei.value.shed_at == "submit"
    assert a._state == "pending"             # no-deadline work never evicted


def test_engine_overload_shed_counted(index):
    from repro_torch.obs import MetricsRegistry

    idx, vecs = index
    reg = MetricsRegistry()
    # long linger so the queue holds submissions; capacity 4 < the burst
    eng = AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=None,
                           linger_ms=500.0, max_queue=4, metrics=reg)
    try:
        admitted, shed = [], 0
        for q in vecs[:7]:
            try:
                admitted.append(eng.submit(q))
            except OverloadError:
                shed += 1
        assert shed == 3 and len(admitted) == 4
        for f in admitted:                   # admitted work still served
            ids, _ = f.result(120.0)
            assert (ids >= 0).any()
    finally:
        eng.close()
    assert eng.stats.shed == 3
    assert reg.counter("serving_shed_total").value == 3


# -- degradation ladder -----------------------------------------------------

def _base_cfg(k=10, beam=64):
    return ProgramConfig(k=k, eps=0.1, beam_width=beam, codec="float32",
                         rerank_k=None, expand_width=1, visited_size=256,
                         hop_backend="composed")


def test_build_ladder_rungs():
    rungs = build_ladder(_base_cfg(), degree=16)
    assert [r.name for r in rungs] == ["base", "slim-beam", "hop-cap", "sq8"]
    assert rungs[0].cfg.beam_width == 64 and rungs[0].hop_budget is None
    assert rungs[1].cfg.beam_width == 48
    # hop budget derives from the default allowance (4L+64), not L itself
    assert rungs[2].hop_budget == (4 * 48 + 64) // 2
    assert rungs[2].cfg.beam_width == 48
    assert rungs[3].cfg.codec == "sq8" and rungs[3].cfg.rerank_k == 20
    assert rungs[3].hop_budget == rungs[2].hop_budget


def test_build_ladder_no_quant_rung_for_compressed_base():
    rungs = build_ladder(
        ProgramConfig(k=10, eps=0.1, beam_width=64, codec="sq8",
                      rerank_k=40, expand_width=1, visited_size=256,
                      hop_backend="composed"), degree=16)
    assert [r.name for r in rungs] == ["base", "slim-beam", "hop-cap"]


def test_build_ladder_truncation_and_no_rerank():
    rungs = build_ladder(_base_cfg(), degree=16,
                         policy=DegradePolicy(max_rung=1))
    assert [r.name for r in rungs] == ["base", "slim-beam"]
    rungs = build_ladder(_base_cfg(), degree=16,
                         policy=DegradePolicy(last_rung_rerank=None))
    assert rungs[3].cfg.rerank_k is None


def test_ladder_controller_hysteresis():
    moves = []
    ctl = LadderController(4, capacity=16,
                           policy=DegradePolicy(down_after=3, up_after=4),
                           on_change=lambda o, n, d: moves.append((o, n, d)))
    # two hot observations then a dead-band one: streak resets, no move
    assert ctl.observe(8) == 0 and ctl.observe(9) == 0
    assert ctl.observe(4) == 0
    assert ctl.observe(8) == 0 and ctl.observe(8) == 0
    assert ctl.observe(8) == 1               # third consecutive hot: down
    # cold streak must reach up_after before stepping back up
    for _ in range(3):
        assert ctl.observe(0) == 1
    assert ctl.observe(0) == 0               # fourth consecutive cold: up
    assert moves == [(0, 1, "down"), (1, 0, "up")]


def test_ladder_requires_bounded_queue(index):
    idx, _ = index
    with pytest.raises(ValueError):
        AsyncQueryEngine(idx, k=5, degrade=True)


def test_engine_degrades_under_backlog(index):
    """Sustained backlog over the hot threshold steps the ladder down:
    served futures carry the degraded flag, the transition lands in the
    metrics, and the engine recovers to serve everything admitted."""
    from repro_torch.obs import MetricsRegistry

    idx, vecs = index
    reg = MetricsRegistry()
    rng = np.random.default_rng(3)
    qs = vecs[rng.integers(0, 400, 600)] + 0.01 * rng.normal(
        size=(600, 8)).astype(np.float32)
    eng = AsyncQueryEngine(idx, k=5, max_batch=4, deadline_ms=None,
                           linger_ms=0.0, max_queue=8, degrade=True,
                           metrics=reg)
    try:
        eng.warmup()                         # rung programs precompiled
        futs, i = [], 0
        deadline = time.monotonic() + 60.0
        # keep the queue pinned at capacity until the ladder engages:
        # each flush then observes a hot backlog, and down_after
        # consecutive hot flushes step the rung down
        while eng.stats.degraded == 0 and time.monotonic() < deadline:
            try:
                futs.append(eng.submit(qs[i % len(qs)]))
            except OverloadError:
                time.sleep(0.0005)
            i += 1
        for f in futs:
            ids, _ = f.result(120.0)
            assert (ids >= 0).any()
    finally:
        eng.close()
    assert eng.stats.degraded > 0
    assert any(f.degraded and f.degrade_level >= 1 for f in futs)
    assert reg.counter("serving_degrade_transitions_total",
                       direction="down").value >= 1
    assert reg.counter("serving_degraded_total").value == eng.stats.degraded


# -- fault injection --------------------------------------------------------

def test_fault_plan_deterministic_across_runs():
    def fired(seed):
        plan = FaultPlan(seed=seed).kill("p", prob=0.3, times=None)
        hits = []
        for i in range(200):
            try:
                plan.fire("p")
            except FaultInjected as e:
                hits.append(i)
        return hits

    a, b = fired(7), fired(7)
    assert a == b and len(a) > 0             # same seed: same schedule


def test_fault_plan_at_and_times():
    plan = FaultPlan().kill("p", at=3)
    plan.fire("p")
    plan.fire("p")
    with pytest.raises(FaultInjected) as ei:
        plan.fire("p")
    assert ei.value.point == "p" and ei.value.hit == 3
    plan.fire("p")                           # times=1: never fires again
    assert plan.counts() == {"p": 1}


def test_fault_plan_parse_roundtrip():
    plan = FaultPlan.parse("a.b:kill@2;c.d:delay=0.0*3;e.f:kill%0.5")
    rules = {(r.point, r.op): r for r in plan._rules}
    assert rules[("a.b", "kill")].at == 2
    assert rules[("c.d", "delay")].arg == 0.0
    assert rules[("c.d", "delay")].times == 3
    assert rules[("e.f", "kill")].prob == 0.5
    with pytest.raises(ValueError):
        FaultPlan.parse("a.b:explode")


def test_fault_call_rule_gets_context():
    seen = {}
    plan = FaultPlan().call("wal.append", lambda **ctx: seen.update(ctx),
                            at=1)
    plan.fire("wal.append", seq=4, op="add", path="x")
    assert seen == {"seq": 4, "op": "add", "path": "x"}


def test_clock_skew_shifts_serving_clock():
    from repro_torch.obs import clock

    t0 = clock.now()
    with clock_skew(100.0):
        assert clock.now() - t0 > 99.0
    assert clock.now() - t0 < 10.0


# -- watchdog / supervisor (satellite: result() must never hang) ------------

def test_result_fails_typed_when_engine_dies(index):
    """Regression: a scheduler-thread death used to strand every pending
    future — result() blocked forever.  The watchdog must fail them with
    EngineCrashedError promptly, and later submits must refuse."""
    idx, vecs = index
    eng = AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=None,
                           linger_ms=300.0, max_restarts=0)
    try:
        futs = [eng.submit(q) for q in vecs[:4]]
        with FaultPlan().kill("scheduler.loop", at=1):
            for f in futs:
                with pytest.raises(EngineCrashedError) as ei:
                    f.result(30.0)           # typed, well before timeout
                assert ei.value.thread == "scheduler"
            with pytest.raises(EngineCrashedError):
                eng.submit(vecs[0])
            assert eng.health()["status"] == "crashed"
            assert eng.stats.crashes == 1 and eng.stats.restarts == 0
    finally:
        eng.close()


def test_supervisor_restarts_crashed_loops(index):
    idx, vecs = index
    eng = AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=None,
                           linger_ms=50.0, max_restarts=3)
    try:
        with FaultPlan().kill("scheduler.loop", at=1):
            pending = eng.submit(vecs[0])
            with pytest.raises(EngineCrashedError):
                pending.result(30.0)         # the casualty of the crash
        deadline = time.monotonic() + 30.0
        while eng.stats.restarts == 0:       # supervisor revives the loops
            assert time.monotonic() < deadline, "supervisor never restarted"
            time.sleep(0.01)
        ids, _ = eng.submit(vecs[1]).result(120.0)
        assert (ids >= 0).any()
        assert eng.stats.crashes == 1 and eng.stats.restarts == 1
        assert eng.health()["status"] == "ok"
    finally:
        eng.close()


def test_chaos_every_submit_resolves_typed(index):
    """The chaos contract: under seeded kills and delays on both loop
    threads, every submission ends in exactly one of a result, a typed
    rejection, or a typed crash error — zero hangs, zero silent losses."""
    idx, vecs = index
    rng = np.random.default_rng(4)
    qs = vecs[rng.integers(0, 400, 80)] + 0.01 * rng.normal(
        size=(80, 8)).astype(np.float32)
    plan = (FaultPlan(seed=11)
            .kill("scheduler.loop", prob=0.02, times=2)
            .kill("extract.loop", prob=0.02, times=2)
            .delay("scheduler.dispatch", 0.002, prob=0.2, times=None))
    eng = AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=None,
                           linger_ms=1.0, max_queue=32, max_restarts=10)
    outcomes = {"served": 0, "shed": 0, "crashed": 0}
    try:
        with plan:
            futs = []
            for q in qs:
                try:
                    futs.append(eng.submit(q))
                except OverloadError:
                    outcomes["shed"] += 1
                except EngineCrashedError:
                    outcomes["crashed"] += 1
                    time.sleep(0.02)         # give the supervisor a beat
            for f in futs:
                try:
                    ids, dists = f.result(60.0)
                except OverloadError:
                    outcomes["shed"] += 1
                except EngineCrashedError:
                    outcomes["crashed"] += 1
                except CancelledError:
                    outcomes["crashed"] += 1
                else:
                    outcomes["served"] += 1
                    assert (ids >= 0).any() and np.isfinite(dists).any()
    finally:
        eng.close()
    assert sum(outcomes.values()) == len(qs), \
        f"accounting leak: {outcomes} vs {len(qs)} submissions"
    assert outcomes["served"] > 0            # chaos didn't stop the engine


def test_chaos_mutation_under_serving_resolves_typed():
    """The live-mutation extension of the trichotomy contract: a writer
    thread refines + republishes and the integrity scrubber audits while
    queries flow, with seeded delays on the scrub / publish / dispatch
    hooks.  Every submission still resolves typed, and every *served*
    result must be bit-identical to a replay against the published epoch
    stamped on it — a torn read could return plausible-looking garbage
    this check refuses."""
    import threading

    from repro_torch.serving import buckets as _buckets
    from repro_torch.serving.scrub import IntegrityScrubber

    rng = np.random.default_rng(21)
    vecs = rng.normal(size=(300, 8)).astype(np.float32)
    idx = build_deg(vecs, DEGParams(degree=8, k_ext=16), wave_size=8,
                     device="cpu")
    mgr = idx.enable_publishing()
    idx.refine(4, seed=99)                   # pre-warm the writer path
    idx.publish()
    kept = {e: mgr.live[e] for e in mgr.live_epochs()}
    kept_lock = threading.Lock()
    orig_publish = mgr.publish

    def keeping_publish(ep):                 # hold every epoch for replay
        with kept_lock:
            kept[ep.epoch] = ep
        orig_publish(ep)

    mgr.publish = keeping_publish
    qs = vecs[rng.integers(0, 300, 60)] + 0.01 * rng.normal(
        size=(60, 8)).astype(np.float32)
    plan = (FaultPlan(seed=11)
            .delay("scrub.audit", 0.002, prob=0.5, times=None)
            .delay("publish.swap", 0.001, prob=0.5, times=None)
            .delay("scheduler.dispatch", 0.002, prob=0.2, times=None))
    eng = AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=None,
                           linger_ms=1.0, max_queue=32, max_restarts=10)
    scrub = IntegrityScrubber(idx, interval_s=0.02)
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            idx.refine(4, seed=i)
            idx.publish()
            i += 1
            time.sleep(0.005)

    wt = threading.Thread(target=writer, daemon=True)
    outcomes = {"served": 0, "shed": 0, "crashed": 0}
    served = []
    try:
        with plan:
            scrub.start()
            wt.start()
            futs = []
            for q in qs:
                try:
                    futs.append((q, eng.submit(q)))
                except OverloadError:
                    outcomes["shed"] += 1
                except EngineCrashedError:
                    outcomes["crashed"] += 1
                    time.sleep(0.02)
            for q, f in futs:
                try:
                    ids, dists = f.result(60.0)
                except OverloadError:
                    outcomes["shed"] += 1
                except EngineCrashedError:
                    outcomes["crashed"] += 1
                except CancelledError:
                    outcomes["crashed"] += 1
                else:
                    outcomes["served"] += 1
                    served.append((q, ids, dists, f.epoch))
    finally:
        stop.set()
        wt.join(timeout=60.0)
        scrub.stop()
        eng.close()
    assert sum(outcomes.values()) == len(qs), \
        f"accounting leak: {outcomes} vs {len(qs)} submissions"
    assert outcomes["served"] > 0
    seen_epochs = sorted({e for *_, e in served})
    assert seen_epochs[-1] > 0, "no served result saw a republished epoch"
    for q, ids, dists, e in served:
        ep = kept[e]
        items = [_buckets.BatchItem(query=q, exclude=ep.quarantine)]
        pqs, seeds, excl = _buckets.pad_batch(items, 1, ep.medoid())
        res = _buckets.dispatch(ep, eng.cfg, pqs, seeds, excl)
        assert np.array_equal(ids, np.asarray(res.ids)[0]), \
            f"torn read: epoch {e} replay disagrees"
        assert np.array_equal(dists, np.asarray(res.dists)[0])


# -- /healthz ---------------------------------------------------------------

def test_healthz_endpoint_states(index):
    from repro_torch.obs import MetricsRegistry, serve_metrics

    idx, vecs = index
    srv = serve_metrics(MetricsRegistry(), 0)
    url = f"http://{srv.host}:{srv.port}/healthz"
    try:
        with urllib.request.urlopen(url) as r:   # no engine yet: booting
            assert r.status == 200
            assert json.load(r)["status"] == "booting"
        eng = AsyncQueryEngine(idx, k=5, max_batch=8, deadline_ms=None,
                               max_queue=16, max_restarts=0)
        srv.set_health(eng.health)
        try:
            with urllib.request.urlopen(url) as r:
                doc = json.load(r)
                assert r.status == 200 and doc["status"] == "ok"
                assert doc["max_queue"] == 16
            with FaultPlan().kill("scheduler.loop", at=1):
                with pytest.raises(EngineCrashedError):
                    eng.submit(vecs[0]).result(30.0)
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(url)  # crashed: 503, LB ejects
                assert ei.value.code == 503
                assert json.load(ei.value)["status"] == "crashed"
        finally:
            eng.close()
    finally:
        srv.close()
