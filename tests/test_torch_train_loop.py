"""The twin of ``tests/test_train_fault_tolerance.py`` for the port's
training substrate (``repro_torch.train``, ``repro_torch.data.pipeline``),
held against the JAX package on the CPU.

* The toy regression's train steps (AdamW, clip 1.0) against JAX's, one
  batch at a time and over 4 microbatches, at rtol 1e-6 (float32 on both
  sides; the clip's global norm and the microbatch mean add in other
  orders), with an atol of 1e-6 times the largest parameter.
* Resume-exact after ``fail_at=12``, loss falls, the checkpoint round
  trip, the ``.tmp`` orphan and ``keep``, bf16 leaves.
* Checkpoints cross: a JAX-written one restores in the port with every
  leaf equal, a port-written one restores in JAX, and both packages write
  the same bytes for the same state.
* ``ShardedPipeline`` / ``lm_synthetic_batch_fn`` byte-equal to JAX's.

The port updates its parameters in place, so every run starts from its
own copy of the initial parameters.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.data import pipeline as tpipe
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import tree as T
from repro_torch.train.loop import InjectedFailure, LoopConfig, train_loop
from repro_torch.train.optimizer import adamw
from repro_torch.train.steps import make_eval_step, make_train_step
from _torch_threads import _one_torch_thread  # noqa: F401

RTOL = 1e-6


def _init(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 2)).astype(np.float32),
            "b": np.zeros((2,), np.float32)}


def _batch_np(s):
    r = np.random.default_rng((7, s))
    x = r.normal(size=(8, 4)).astype(np.float32)
    w_true = np.arange(8).reshape(4, 2).astype(np.float32)
    return {"x": x,
            "y": x @ w_true + 0.01 * r.normal(size=(8, 2)).astype(np.float32)}


def _toy_setup(seed=0, microbatches=1):
    """The JAX test's toy setup in the port: (step, params, opt_state,
    batch_fn), the parameters a fresh copy."""
    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        l = torch.mean((pred - batch["y"]) ** 2)
        return l, {"mse": l}

    params = T.tree_map(torch.tensor, _init(seed))
    opt = adamw(1e-2)
    step = make_train_step(loss_fn, opt, microbatches)

    def batch_fn(s):
        return T.tree_map(torch.from_numpy, _batch_np(s))

    return step, params, opt.init(params), batch_fn


def _jax_toy(seed=0, microbatches=1):
    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        l = jnp.mean((pred - batch["y"]) ** 2)
        return l, {"mse": l}

    params = jax.tree.map(jnp.asarray, _init(seed))
    opt = jopt.adamw(1e-2)
    step = jsteps.make_train_step(loss_fn, opt, microbatches=microbatches,
                                  donate=False)

    def batch_fn(s):
        return jax.tree.map(jnp.asarray, _batch_np(s))

    return step, params, opt.init(params), batch_fn


def _close(got, want):
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=RTOL * scale, err_msg=k)


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_steps_match_jax(microbatches):
    step, params, state, batch_fn = _toy_setup(microbatches=microbatches)
    jstep, jparams, jstate, jbatch_fn = _jax_toy(microbatches=microbatches)
    for s in range(20):
        (params, state), m = step(params, state, batch_fn(s))
        (jparams, jstate), jm = jstep(jparams, jstate, jbatch_fn(s))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=RTOL * 10)
        assert set(m) == set(jm) == {"loss", "mse"}
        _close(T.tree_map(lambda x: x.numpy(), params), jparams)
    assert int(state["count"]) == int(jstate["count"]) == 20


def test_microbatches_accumulate_the_mean_gradient():
    """Over 4 microbatches the step takes the mean of their gradients: the
    same update as one batch, to float32 rounding."""
    one, p1, s1, batch_fn = _toy_setup()
    four, p4, s4, _ = _toy_setup(microbatches=4)
    (p1, _), m1 = one(p1, s1, batch_fn(0))
    (p4, _), m4 = four(p4, s4, batch_fn(0))
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    _close(T.tree_map(lambda x: x.numpy(), p4),
           T.tree_map(lambda x: x.numpy(), p1))
    with pytest.raises(ValueError, match="microbatches"):
        _toy_setup(microbatches=3)[0](*_toy_setup()[1:3], batch_fn(0))


@pytest.mark.parametrize("microbatches,split", [(1, False), (4, False),
                                                 (1, True)])
def test_train_step_leaves_no_tensor_in_a_reference_cycle(microbatches,
                                                         split):
    """A step's gradients and updates are freed when it returns: nothing
    on its path (the tree walks, the optimizers, the partitioned split)
    forms a reference cycle that would hold them until the cyclic
    collector runs."""
    import gc

    from repro_torch.train.optimizer import partitioned, sgd

    step, params, state, batch_fn = _toy_setup(microbatches=microbatches)
    if split:
        opt = partitioned(lambda path, leaf: path[0],
                          {"w": sgd(0.1), "b": adamw(1e-2)})
        step = make_train_step(
            lambda p, b: (torch.mean((b["x"] @ p["w"] + p["b"] - b["y"])
                                     ** 2), {}), opt, microbatches)
        state = opt.init(params)
    batch = batch_fn(0)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        for _ in range(2):
            (params, state), _m = step(params, state, batch)
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []


def test_eval_step_takes_no_gradient():
    _, params, _, batch_fn = _toy_setup()

    def loss_fn(p, b):
        l = torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)
        return l, {"mse": l}

    m = make_eval_step(loss_fn)(params, batch_fn(0))
    assert set(m) == {"loss", "mse"} and not m["loss"].requires_grad


def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(6).reshape(2, 3),
             "nested": {"b": torch.ones((4,), dtype=torch.bfloat16) * 1.5},
             "scalar": torch.tensor(3, dtype=torch.int32)}
    path = ckpt.save(str(tmp_path), 7, state, mesh_shape=(16, 16))
    assert os.path.isdir(path)
    assert ckpt.latest_step(str(tmp_path)) == 7
    like = T.tree_map(lambda x: torch.empty(x.shape, device="meta"), state)
    restored, manifest = ckpt.restore_latest(str(tmp_path), like,
                                             device="cpu")
    assert manifest["mesh_shape"] == [16, 16]
    for (path, a), (_, b) in zip(T.leaves_with_path(state),
                                 T.leaves_with_path(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_checkpoint_atomic_no_partial(tmp_path):
    state = {"w": torch.ones((3,))}
    ckpt.save(str(tmp_path), 1, state)
    # a crashed half-write leaves only a .tmp dir -> invisible to LATEST
    os.makedirs(tmp_path / "step_000000002.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 1
    ckpt.save(str(tmp_path), 3, state)   # gc removes the orphan
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_checkpoint_gc_keeps_newest(tmp_path):
    state = {"w": torch.ones((2,))}
    for s in range(5):
        ckpt.save(str(tmp_path), s, state, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(steps) == 2 and steps[-1] == "step_000000004"


def test_checkpoint_restore_checks_keys_and_shapes(tmp_path):
    ckpt.save(str(tmp_path), 0, {"w": torch.ones((3,))})
    with pytest.raises(KeyError, match="missing leaf 'v'"):
        ckpt.restore(str(tmp_path), 0, {"v": torch.ones((3,))})
    with pytest.raises(ValueError, match="saved"):
        ckpt.restore(str(tmp_path), 0, {"w": torch.ones((4,))})


def test_resume_is_exact(tmp_path):
    """Crash at step 12, resume: final params must equal an uninterrupted
    run (deterministic replay contract)."""
    step, params, opt_state, batch_fn = _toy_setup()
    (ref_params, _), _ = train_loop(
        step, params, opt_state, batch_fn,
        LoopConfig(total_steps=20, log_every=0))
    step2, params2, opt_state2, _ = _toy_setup()
    cfg = LoopConfig(total_steps=20, ckpt_dir=str(tmp_path), ckpt_every=5,
                     log_every=0, fail_at=12, fail_before_ckpt=True)
    with pytest.raises(InjectedFailure):
        train_loop(step2, params2, opt_state2, batch_fn, cfg)
    assert ckpt.latest_step(str(tmp_path)) == 10
    step3, params3, opt_state3, _ = _toy_setup()
    cfg2 = LoopConfig(total_steps=20, ckpt_dir=str(tmp_path), ckpt_every=5,
                      log_every=0)
    (resumed, _), hist = train_loop(step3, params3, opt_state3, batch_fn,
                                    cfg2)
    assert hist[0]["step"] == 11 and hist[-1]["step"] == 19
    for k in ref_params:
        torch.testing.assert_close(resumed[k], ref_params[k], rtol=RTOL,
                                   atol=0)


def test_fail_after_checkpoint_loses_no_work(tmp_path):
    step, params, state, batch_fn = _toy_setup()
    cfg = LoopConfig(total_steps=20, ckpt_dir=str(tmp_path), ckpt_every=5,
                     log_every=0, fail_at=10, fail_before_ckpt=False)
    with pytest.raises(InjectedFailure):
        train_loop(step, params, state, batch_fn, cfg)
    assert ckpt.latest_step(str(tmp_path)) == 10


def test_loss_decreases_end_to_end():
    step, params, opt_state, batch_fn = _toy_setup()
    (_, _), hist = train_loop(step, params, opt_state, batch_fn,
                              LoopConfig(total_steps=40, log_every=0))
    assert hist[-1]["loss"] < 0.5 * hist[0]["loss"]
    assert all(h["step_time"] >= 0 for h in hist)


def _jax_state(step_count=3):
    """A JAX train state after ``step_count`` toy steps, bf16 leaf added."""
    jstep, jparams, jstate, jbatch_fn = _jax_toy()
    for s in range(step_count):
        (jparams, jstate), _ = jstep(jparams, jstate, jbatch_fn(s))
    return {"params": jparams, "opt": jstate,
            "extra": {"half": jnp.linspace(-2, 2, 6).astype(jnp.bfloat16)}}


def _port_state(jstate):
    """The same state as the port's tensors."""
    def t(x):
        x = np.array(x)                                 # a writable copy
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(x)

    return jax.tree.map(t, jstate)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_state()
    jckpt.save(str(tmp_path), 3, jstate, mesh_shape=(2, 2))
    like = _port_state(jstate)
    got, manifest = ckpt.restore_latest(str(tmp_path), like)
    assert manifest["step"] == 3 and manifest["mesh_shape"] == [2, 2]
    for (path, a), (_, b) in zip(T.leaves_with_path(got),
                                 T.leaves_with_path(like)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert got["extra"]["half"].dtype == torch.bfloat16
    assert got["opt"]["count"].dtype == torch.int32


def test_port_checkpoint_restores_in_jax_byte_for_byte(tmp_path):
    jstate = _jax_state()
    tstate = _port_state(jstate)
    ckpt.save(str(tmp_path / "port"), 3, tstate, mesh_shape=(2, 2),
              extra={"arch": "toy"})
    jckpt.save(str(tmp_path / "jax"), 3, jstate, mesh_shape=(2, 2),
               extra={"arch": "toy"})
    a, b = tmp_path / "port" / "step_000000003", tmp_path / "jax" / \
        "step_000000003"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    assert (tmp_path / "port" / "LATEST").read_text() == \
        (tmp_path / "jax" / "LATEST").read_text()
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jstate)
    got, _ = jckpt.restore_latest(str(tmp_path / "port"), like)
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(
        np.asarray(x, np.float32), np.asarray(y, np.float32)), got, jstate)
    assert got["extra"]["half"].dtype == jnp.bfloat16


def test_resume_in_the_port_from_a_jax_run(tmp_path):
    """A JAX loop crashes at step 7 after its step-5 checkpoint; the port
    resumes from it and its final parameters match the uninterrupted JAX
    run's."""
    jstep, jparams, jstate, jbatch_fn = _jax_toy()
    (want, _), _ = jloop.train_loop(jstep, jparams, jstate, jbatch_fn,
                                    jloop.LoopConfig(total_steps=12,
                                                     log_every=0))
    cfg = dict(total_steps=12, ckpt_dir=str(tmp_path), ckpt_every=5,
               log_every=0)
    jstep, jparams, jstate, jbatch_fn = _jax_toy()
    with pytest.raises(jloop.InjectedFailure):
        jloop.train_loop(jstep, jparams, jstate, jbatch_fn,
                         jloop.LoopConfig(fail_at=7, **cfg))
    step, params, state, batch_fn = _toy_setup()
    (got, _), hist = train_loop(step, params, state, batch_fn,
                                LoopConfig(**cfg))
    assert hist[0]["step"] == 6
    _close(T.tree_map(lambda x: x.numpy(), got), want)


def test_pipeline_batches_byte_equal_to_jax():
    for seed, step in ((3, 5), (0, 0), (11, 40)):
        a = tpipe.lm_synthetic_batch_fn(vocab=50, batch=8, seq=16,
                                        seed=seed)(step)
        b = jpipe.lm_synthetic_batch_fn(vocab=50, batch=8, seq=16,
                                        seed=seed)(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and \
                a[k].tobytes() == b[k].tobytes(), k


def test_pipeline_shard_determinism():
    fn = tpipe.lm_synthetic_batch_fn(vocab=50, batch=8, seq=16, seed=3)
    p0 = tpipe.ShardedPipeline(fn, host_id=0, num_hosts=2)
    p1 = tpipe.ShardedPipeline(fn, host_id=1, num_hosts=2)
    g = fn(5)
    b0, b1 = p0(5), p1(5)
    np.testing.assert_array_equal(
        np.concatenate([b0["tokens"], b1["tokens"]]), g["tokens"])
    np.testing.assert_array_equal(p0(5)["tokens"], b0["tokens"])
    j1 = jpipe.ShardedPipeline(
        jpipe.lm_synthetic_batch_fn(vocab=50, batch=8, seq=16, seed=3),
        host_id=1, num_hosts=2)(5)
    assert b1["labels"].tobytes() == j1["labels"].tobytes()
    with pytest.raises(ValueError, match="hosts"):
        tpipe.host_shard(g, 0, 3)


def test_pipeline_prefetch_stream():
    fn = tpipe.lm_synthetic_batch_fn(vocab=50, batch=4, seq=8, seed=0)
    p = tpipe.ShardedPipeline(fn, prefetch=2).start(start_step=3)
    try:
        s, b = p.get()
        assert s == 3 and b["tokens"].tobytes() == fn(3)["tokens"].tobytes()
        s2, _ = p.get()
        assert s2 == 4
    finally:
        p.stop()
    assert p._thread is None
