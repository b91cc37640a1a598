"""LM training in the port against the JAX package on the CPU, float32:

* ``transformer.loss_fn`` and the gradient of every parameter against
  ``jax.grad`` for the five reduced configs (rtol 1e-4 atol 1e-6), with -1
  labels among the targets (JAX wraps their gather index to the last
  column, the port clamps it to 0; the mask removes either), and once
  under ``remat`` (``torch.utils.checkpoint``);
* 3 AdamW steps of ``train.steps.make_train_step`` against JAX's, the
  parameters and the optimizer state after them;
* ``launch.train.main([... "--seq", ...])`` on LM archs failing and
  resuming on the CPU.

AdamW divides each gradient by its own running size, so an entry whose
gradient sits at float32 noise (a sum that cancels to 1e-9 where its leaf
reads 1e-3) moves by about the learning rate in either package whatever
the noise's sign.  The step test holds every entry at rtol 1e-4 atol 1e-6
but at most ``NOISE_SHARE`` of each leaf's, which may part by up to twice
the learning rate a step (2 of the reduced granite's 8,192 ``wo``
entries after one step)."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.data.pipeline import lm_synthetic_batch_fn as jstream
from repro.models import transformer as JT
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro_torch.data.pipeline import lm_synthetic_batch_fn
from repro_torch.interop import (lm_model_from_numpy, opt_state_from_numpy,
                                 opt_state_to_numpy)
from repro_torch.models import transformer as TT
from repro_torch.models.recsys import as_tensors
from repro_torch.train import optimizer as topt
from repro_torch.train import tree as T
from repro_torch.train.steps import make_train_step
from _torch_threads import _one_torch_thread  # noqa: F401

LM_ARCHS = ["phi3-mini-3.8b", "granite-3-2b", "gemma3-12b",
            "qwen3-moe-30b-a3b", "mixtral-8x22b"]
RTOL, ATOL = 1e-4, 1e-6
LR, STEPS = 1e-3, 3
NOISE_SHARE = 1e-3
B, S = 2, 12


def _cfgs(arch, **kw):
    j = dataclasses.replace(jconfigs.get_arch(arch).reduced(),
                            dtype=jnp.float32, **kw)
    t = dataclasses.replace(tconfigs.get_arch(arch).reduced(),
                            dtype=torch.float32, **kw)
    return j, t


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        JT.init_params(jax.random.PRNGKey(seed), jcfg))


def _batch(cfg, step, masked=True):
    """The launcher's stream at (B, S), some labels set to -1."""
    b = lm_synthetic_batch_fn(cfg.vocab, B, S, seed=0)(step)
    if masked:
        b["labels"][0, ::3] = -1
        b["labels"][1, -1] = -1
    return b


def _assert_tree(got, want, what, steps=0):
    """Every leaf at RTOL / ATOL; after ``steps`` AdamW steps, up to
    NOISE_SHARE of a leaf's entries may part by 2 x LR x steps."""
    g, w = T.leaves_with_path(got), T.leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b)
        if not steps:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} {path}")
            continue
        off = ~np.isclose(a, b, rtol=RTOL, atol=ATOL)
        assert off.mean() <= NOISE_SHARE, (what, path, int(off.sum()))
        if off.any():
            assert np.abs(a - b)[off].max() <= 2 * LR * steps, (what, path)


# every arch, and under remat one dense and one MoE arch
GRAD_CASES = [(a, False) for a in LM_ARCHS] + \
    [("gemma3-12b", True), ("qwen3-moe-30b-a3b", True)]


@pytest.mark.parametrize("arch,remat", GRAD_CASES)
def test_loss_and_gradients_match_jax_grad(arch, remat):
    jcfg, tcfg = _cfgs(arch, remat=remat)
    params = _params(jcfg)
    b = _batch(tcfg, 0)
    model = lm_model_from_numpy(params, tcfg, "cpu")
    # the model is frozen; gradients are taken through views of it
    assert not any(p.requires_grad for p in model.parameters())
    views = T.tree_map(lambda p: p.detach().requires_grad_(),
                       model.params())
    loss, m = TT.loss_fn(views, as_tensors(b, "cpu"), tcfg)
    grads = torch.autograd.grad(loss, T.leaves(views))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    for got, want in ((loss, jloss), (m["nll"], jm["nll"]),
                      (m["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=RTOL, atol=ATOL)
    _assert_tree(T.unflatten(views, list(grads)),
                 jax.tree.map(np.asarray, jgrads), "grad")


def test_masked_labels_take_no_gradient():
    """A -1 label adds nothing: the loss over a batch with one position
    masked equals the loss over the rest, and no position past the
    vocabulary is read."""
    _, tcfg = _cfgs("granite-3-2b")
    model = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    b = as_tensors(_batch(tcfg, 1, masked=False), "cpu")
    full, _ = TT.loss_fn(model, b)
    logits, _ = TT.forward_train(model, b["tokens"])
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, b["labels"].long()[..., None])[..., 0]
    masked = dict(b, labels=b["labels"].clone())
    masked["labels"][0, 0] = -1
    loss, m = TT.loss_fn(model, masked)
    keep = torch.ones_like(nll, dtype=torch.bool)
    keep[0, 0] = False
    torch.testing.assert_close(m["nll"], nll[keep].mean())
    assert not torch.equal(loss, full)


def test_loss_fn_over_a_param_dict_needs_its_config():
    _, tcfg = _cfgs("phi3-mini-3.8b")
    model = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    b = as_tensors(_batch(tcfg, 0), "cpu")
    a, _ = TT.loss_fn(model, b)
    c, _ = TT.loss_fn(model.params(), b, tcfg)
    assert torch.equal(a, c)
    with pytest.raises(ValueError, match="TransformerConfig"):
        TT.loss_fn(model.params(), b)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-30b-a3b"])
def test_adamw_steps_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    params = _params(jcfg)
    jo, to = jopt.adamw(LR), topt.adamw(LR)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jo.init(jparams)
    model = lm_model_from_numpy(params, tcfg, "cpu")
    tparams = model.params()
    state = opt_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jsteps.make_train_step(lambda p, b: JT.loss_fn(p, b, jcfg), jo,
                                   donate=False)
    step = make_train_step(lambda p, b: TT.loss_fn(p, b, tcfg), to)
    for s in range(STEPS):
        b = _batch(tcfg, s)
        (jparams, jstate), jm = jstep(
            jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        (tparams, state), m = step(tparams, state, as_tensors(b, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=RTOL, atol=ATOL)
        _assert_tree(tparams, jax.tree.map(np.asarray, jparams),
                     f"params after step {s}", s + 1)
    assert model.params()["embed"] is tparams["embed"]         # in place
    _assert_tree(opt_state_to_numpy(state, like=jstate),
                 jax.tree.map(np.asarray, jstate), "state", STEPS)
    assert int(state["count"]) == STEPS


def test_lm_stream_equals_jax():
    for s in (0, 5):
        a = lm_synthetic_batch_fn(256, 4, 16, seed=3)(s)
        b = jstream(256, 4, 16, seed=3)(s)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "gemma3-12b"])
def test_launcher_trains_an_lm_and_resumes(arch, tmp_path, capsys):
    from repro_torch.launch import train
    from repro_torch.train.loop import InjectedFailure

    args = ["--arch", arch, "--steps", "24", "--batch", "8", "--seq", "32",
            "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "5"]
    with pytest.raises(InjectedFailure, match="step 12"):
        train.main(args + ["--fail-at", "12"])
    capsys.readouterr()
    train.main(args)
    out = capsys.readouterr().out
    assert "[loop] resumed from step 10" in out
    m = re.search(r"final loss: ([0-9.]+) \(first: ([0-9.]+)\)", out)
    assert float(m.group(1)) < float(m.group(2))


def test_build_reduced_trainer_takes_seq():
    from repro_torch.launch.train import build_reduced_trainer

    step, params, state, batch_fn = build_reduced_trainer(
        "mixtral-8x22b", 3, seq=7, device="cpu")
    b = batch_fn(0)
    assert b["tokens"].shape == b["labels"].shape == (3, 7)
    assert set(params) == set(TT.abstract_params(
        tconfigs.get_arch("mixtral-8x22b").reduced()))
    (params, state), m = step(params, state, b)
    assert torch.isfinite(m["loss"]) and int(state["count"]) == 1
