"""The port's recsys training against the JAX package, on the CPU.

Both packages start from the same weights (the JAX ``init_params`` carried
across by ``interop.recsys_model_from_numpy``) and the same optimizer
state (``interop.opt_state_from_numpy``), on the same batches
(``CriteoLikeStream``, byte-equal in both packages).  Cases: the four
``reduced()`` configs and DIN at its published width (B=16; the table is
256,205 x 18).  Every DIN batch holds one row whose history is all -1.

* ``loss_fn`` and the gradient of every parameter against ``jax.grad``;
* 3 steps of the MLPerf split (SGD on the tables, AdamW on the towers:
  the ``train_batch`` cell's optimizer) against JAX's ``make_train_step``;
* a JAX train state checkpointed mid-run and resumed by the port's loop,
  against JAX's own continuation;
* the planted-logit stream is learnable in the port (the twin of
  ``test_recsys_stream_learnable``);
* serving still runs under ``torch.inference_mode()`` and, on the CPU,
  launches no kernel.

Tolerances: rtol 1e-5 / atol 1e-6 for losses, gradients and parameters
(float32 in both packages; matrix products, bag sums and the clip's norm
add in different orders).  Two leaves are held otherwise after an AdamW
step: DIN's last attention layer (``attn_mlp/w{n}``, ``attn_mlp/b{n}``).
The softmax over the history subtracts the scores' mean, so that layer's
gradient is a cancellation: exactly 0 for the bias (one constant added to
every score), and for the weight at init about 1e-8 (at full width), the
size of AdamW's eps.  Both packages compute it to rounding noise (the
gradient test holds it at atol 1e-6), and AdamW scales the ratio
``g / (|g| + eps)`` of that noise to the learning rate; so after each
step those leaves are held to a change of at most lr x steps from their
start on both sides, instead of to the other package's noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data.recsys import CriteoLikeStream as JStream
from repro.models import recsys as JR
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
import repro_torch.configs as tconfigs
from repro_torch.interop import (opt_state_from_numpy, opt_state_to_numpy,
                                 recsys_model_from_numpy)
from repro_torch.kernels.bag_lookup import ops as bag_ops
from repro_torch.launch.train import mlperf_label
from repro_torch.models import recsys as TR
from repro_torch.train import optimizer as topt
from repro_torch.train import tree as T
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.steps import make_train_step
from _torch_threads import _one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
CASES = ["dcn-v2", "deepfm", "din", "dlrm-mlperf", "din-full"]
STEPS = 3
LR_DENSE = 1e-3                         # the split's AdamW learning rate


def _configs(case):
    if case == "din-full":
        return jconfigs.get_arch("din").model, tconfigs.get_arch("din").model
    return (jconfigs.get_arch(case).reduced(),
            tconfigs.get_arch(case).reduced())


def _batch(cfg, B, step):
    b = JStream(cfg, seed=3).batch(step, B)
    if cfg.kind == "din":
        b["hist"][1, :] = -1                             # an empty history
    return b


def _jax_label(path, leaf):
    return ("embed" if path and getattr(path[0], "key", None)
            in ("table", "fm_w") else "dense")


def _mlperf(m):
    label = _jax_label if m is jopt else mlperf_label
    return m.partitioned(label, {"embed": m.sgd(0.05),
                                 "dense": m.adamw(LR_DENSE)})


@pytest.fixture(scope="module", params=CASES)
def case(request):
    jcfg, tcfg = _configs(request.param)
    params = jax.tree.map(np.asarray,
                          JR.init_params(jax.random.PRNGKey(1), jcfg))
    B = 16 if request.param == "din-full" else 12
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, params=params,
                B=B, batches=[_batch(jcfg, B, s) for s in range(STEPS)])


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _noise_leaves(cfg):
    """DIN's last attention layer: a gradient at the noise floor (see the
    module's docstring)."""
    n = len(cfg.attn_mlp)
    return {("attn_mlp", f"w{n}"), ("attn_mlp", f"b{n}")} \
        if cfg.kind == "din" else set()


def _assert_params(got: dict, want, what, noise=(), start=None, steps=0):
    g, w = T.leaves_with_path(got), T.leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        if path in noise:
            a0 = T.get(start, path)
            bound = LR_DENSE * steps * (1 + 1e-5)
            for side in (a, np.asarray(b)):
                assert np.abs(side - a0).max() <= bound, (what, path)
            continue
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {path}")


def test_gradients_match_jax(case):
    model = recsys_model_from_numpy(case["params"], case["tcfg"],
                                    device="cpu").requires_grad_()
    b = case["batches"][0]
    loss, aux = TR.loss_fn(model, TR.as_tensors(b, "cpu"))
    grads = torch.autograd.grad(loss, T.leaves(model.params()))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JR.loss_fn(p, _jbatch(b), case["jcfg"]), has_aux=True))(
        jax.tree.map(jnp.asarray, case["params"]))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(aux["bce"].item(), float(jaux["bce"]),
                               rtol=RTOL, atol=ATOL)
    got = T.unflatten(model.params(), list(grads))
    _assert_params(got, jax.tree.map(np.asarray, jgrads),
                   "grad")
    # every parameter takes a gradient, the table's rows the batch names
    assert all(g.abs().sum() > 0 for g in grads)


def test_loss_fn_over_a_param_dict_needs_its_config(case):
    model = recsys_model_from_numpy(case["params"], case["tcfg"],
                                    device="cpu")
    b = TR.as_tensors(case["batches"][0], "cpu")
    a, _ = TR.loss_fn(model, b)
    c, _ = TR.loss_fn(model.params(), b, case["tcfg"])
    assert torch.equal(a, c)
    with pytest.raises(ValueError, match="RecsysConfig"):
        TR.loss_fn(model.params(), b)


def test_mlperf_steps_match_jax(case):
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    jo, to = _mlperf(jopt), _mlperf(topt)
    jparams = jax.tree.map(jnp.asarray, case["params"])
    jstate = jo.init(jparams)
    model = recsys_model_from_numpy(case["params"], tcfg, device="cpu")
    params = model.params()
    state = opt_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jsteps.make_train_step(
        lambda p, b: JR.loss_fn(p, b, jcfg), jo, donate=False)
    step = make_train_step(lambda p, b: TR.loss_fn(p, b, tcfg), to)
    for s, b in enumerate(case["batches"]):
        (jparams, jstate), jm = jstep(jparams, jstate, _jbatch(b))
        (params, state), m = step(params, state, TR.as_tensors(b, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=RTOL, atol=ATOL)
        _assert_params(params, jax.tree.map(np.asarray, jparams),
                       f"params after step {s}", _noise_leaves(tcfg),
                       case["params"], s + 1)
    # in place: the model holds the trained parameters
    assert model.params()["table"] is params["table"]
    _assert_params(opt_state_to_numpy(state, like=jstate),
                   jax.tree.map(np.asarray, jstate), "state")
    assert "table" not in state["dense"]["mu"]
    assert int(state["embed"]["count"]) == STEPS


@pytest.mark.parametrize("arch", ["din", "dcn-v2"])
def test_resume_in_the_port_from_a_jax_checkpoint(arch, tmp_path):
    """JAX trains 5 steps with a checkpoint every 2 and crashes after step
    3; the port resumes from the step-2 checkpoint and ends where JAX's
    uninterrupted run ends."""
    jcfg, tcfg = _configs(arch)
    params = jax.tree.map(np.asarray,
                          JR.init_params(jax.random.PRNGKey(2), jcfg))
    B = 16

    def jrun(**kw):
        jo = _mlperf(jopt)
        p = jax.tree.map(jnp.asarray, params)
        step = jsteps.make_train_step(lambda q, b: JR.loss_fn(q, b, jcfg),
                                      jo, donate=False)
        return jloop.train_loop(
            step, p, jo.init(p), lambda s: _jbatch(_batch(jcfg, B, s)),
            jloop.LoopConfig(total_steps=5, log_every=0, **kw))

    (want, _), _ = jrun()
    with pytest.raises(jloop.InjectedFailure):
        jrun(ckpt_dir=str(tmp_path), ckpt_every=2, fail_at=3)
    to = _mlperf(topt)
    model = recsys_model_from_numpy(params, tcfg, device="cpu")
    step = make_train_step(lambda p, b: TR.loss_fn(p, b, tcfg), to)
    (got, state), hist = train_loop(
        step, model.params(), to.init(model.params()),
        lambda s: TR.as_tensors(_batch(jcfg, B, s), "cpu"),
        LoopConfig(total_steps=5, ckpt_dir=str(tmp_path), ckpt_every=2,
                   log_every=0))
    assert [h["step"] for h in hist] == [3, 4]
    _assert_params(got, jax.tree.map(np.asarray, want), "resumed",
                   _noise_leaves(tcfg), params, 5)
    assert int(state["dense"]["count"]) == 5


def test_recsys_stream_learnable():
    """The planted-logit stream is learnable: BCE under training drops
    below where it started (DeepFM reduced, AdamW 5e-3, batches of 256)."""
    from repro_torch.data.recsys import CriteoLikeStream

    cfg = tconfigs.get_arch("deepfm").reduced()
    stream = CriteoLikeStream(cfg, seed=0)
    model = TR.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = topt.adamw(5e-3)
    step = make_train_step(lambda p, b: TR.loss_fn(p, b, cfg), opt)
    params, state = model.params(), opt.init(model.params())
    losses = []
    for s in range(30):
        (params, state), m = step(params, state,
                                  TR.as_tensors(stream.batch(s, 256), "cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.01


def test_serving_stays_frozen_and_in_inference_mode(case):
    """Serving runs under inference mode, on the CPU launches no kernel
    (forward or backward), and a trainable model serves alike; training's
    forward records a graph that serving's does not."""
    tcfg = case["tcfg"]
    frozen = recsys_model_from_numpy(case["params"], tcfg, device="cpu")
    assert not any(p.requires_grad for p in frozen.parameters())
    trainable = recsys_model_from_numpy(case["params"], tcfg,
                                        device="cpu").requires_grad_()
    assert all(p.requires_grad for p in trainable.parameters())
    b = TR.as_tensors(case["batches"][0], "cpu")
    before = (bag_ops.launches, bag_ops.launches_bwd)
    for model in (frozen, trainable):
        y = TR.forward(model, b)
        assert y.is_inference() and not y.requires_grad
        u = TR.user_embedding(model, b)
        assert u.is_inference()
    assert torch.equal(TR.forward(frozen, b), TR.forward(trainable, b))
    loss, _ = TR.loss_fn(trainable, b)
    assert loss.requires_grad and not loss.is_inference()
    loss.backward()
    assert trainable.table.grad is not None
    assert (bag_ops.launches, bag_ops.launches_bwd) == before
    fresh = TR.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in fresh.parameters())
    fresh.requires_grad_()
    assert all(p.requires_grad for p in fresh.parameters())
