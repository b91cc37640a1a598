"""EGNN training in the port against the JAX package on the CPU, float32:

* three steps of the launcher's ``gnn`` trainer
  (``launch.train.build_reduced_trainer("egnn", ...)``: AdamW under the
  cosine schedule) against JAX's ``make_train_step`` with the same
  optimizer, from JAX's parameters and optimizer state on JAX's batches:
  the loss at rtol 1e-5, the parameters and the state at rtol 1e-4 atol
  1e-6; the port's own batches hold the JAX launcher's seeds, features
  and labels;
* ``launch.train.main(["--arch", "egnn", ...])`` failing and resuming;
* an EGNN train state checkpointed by either package restored by the
  other, and the two packages' files byte for byte equal.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.train import build_reduced_trainer as jbuild
from repro.train import checkpoint as jckpt
from repro_torch.interop import (egnn_params_from_numpy, egnn_params_to_numpy,
                                 opt_state_from_numpy, opt_state_to_numpy)
from repro_torch.launch.train import build_reduced_trainer
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import tree as T
from _torch_threads import _one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-6
B, STEPS = 16, 3


@pytest.fixture(scope="module")
def jax_run():
    """The JAX launcher's trainer: its initial parameters and state (numpy),
    its first STEPS batches and what each step left."""
    jstep, jparams, jstate, jbatch_fn = jbuild("egnn", B, 64)
    init = (jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray,
                                                             jstate))
    batches, after = [], []
    for s in range(STEPS):
        b = jbatch_fn(s)
        batches.append({k: np.asarray(v) for k, v in b.items()})
        (jparams, jstate), m = jstep(jparams, jstate, b)
        after.append((float(m["loss"]), jax.tree.map(np.asarray, jparams),
                      jax.tree.map(np.asarray, jstate)))
    return {"init": init, "batches": batches, "after": after,
            "jstate": jstate}


def _assert_tree(got, want, what):
    g, w = T.leaves_with_path(got), T.leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {path}")


def test_three_steps_match_jax(jax_run):
    step, _, _, _ = build_reduced_trainer("egnn", B, device="cpu")
    jparams, jstate = jax_run["init"]
    params = egnn_params_from_numpy(jparams, "cpu")
    state = opt_state_from_numpy(jstate, "cpu")
    for s, (jb, (jloss, jp, js)) in enumerate(zip(jax_run["batches"],
                                                  jax_run["after"])):
        (params, state), m = step(params, state,
                                  {k: torch.tensor(v) for k, v in jb.items()})
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=1e-5,
                                   atol=0)
        _assert_tree(params, jp, f"params after step {s}")
        _assert_tree(opt_state_to_numpy(state, like=js), js,
                     f"state after step {s}")
    assert int(state["count"]) == STEPS


def test_port_batches_hold_the_jax_launchers_seeds(jax_run):
    """The port's batches sample with its own generator, so only the seeds'
    rows match JAX's: features, coordinates and labels of the first B
    nodes, and -1 labels past them; the shapes and dtypes all match."""
    _, params, state, batch_fn = build_reduced_trainer("egnn", B,
                                                       device="cpu")
    for s, jb in enumerate(jax_run["batches"]):
        tb = batch_fn(s)
        assert set(tb) == set(jb)
        for k, v in jb.items():
            assert tuple(tb[k].shape) == v.shape, k
            assert tb[k].numpy().dtype == v.dtype, k
        for k in ("feats", "coords", "labels"):
            np.testing.assert_array_equal(tb[k][:B].numpy(), jb[k][:B])
        np.testing.assert_array_equal(tb["labels"].numpy(), jb["labels"])
        again = batch_fn(s)
        assert all(torch.equal(again[k], tb[k]) for k in tb)
    assert T.leaves_with_path(params)[0][0] == ("decoder", "b0")
    assert int(state["count"]) == 0


def test_launcher_trains_egnn_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train
    from repro_torch.train.loop import InjectedFailure

    args = ["--arch", "egnn", "--steps", "24", "--batch", "8", "--device",
            "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "5"]
    with pytest.raises(InjectedFailure, match="step 12"):
        train.main(args + ["--fail-at", "12"])
    capsys.readouterr()
    train.main(args)
    out = capsys.readouterr().out
    assert "[loop] resumed from step 10" in out
    m = re.search(r"final loss: ([0-9.]+) \(first: ([0-9.]+)\)", out)
    assert float(m.group(1)) < float(m.group(2))


def _state(jax_run):
    _, jp, js = jax_run["after"][-1]
    return {"params": jp, "opt": js}


def test_jax_checkpoint_restores_in_the_port(jax_run, tmp_path):
    jstate = _state(jax_run)
    jckpt.save(str(tmp_path), 2, jstate, mesh_shape=(1, 1))
    like = {"params": egnn_params_from_numpy(
                T.tree_map(np.zeros_like, jstate["params"]), "cpu"),
            "opt": opt_state_from_numpy(
                T.tree_map(np.zeros_like, jstate["opt"]), "cpu")}
    got, manifest = ckpt.restore_latest(str(tmp_path), like)
    assert manifest["step"] == 2
    assert [p for p, _ in T.leaves_with_path(got)] == \
        [p for p, _ in T.leaves_with_path(jstate)]
    for (path, a), (_, b) in zip(T.leaves_with_path(got),
                                 T.leaves_with_path(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=str(path))
        assert a.numpy().dtype == np.asarray(b).dtype


def test_port_checkpoint_restores_in_jax_byte_for_byte(jax_run, tmp_path):
    jstate = _state(jax_run)
    tstate = {"params": egnn_params_from_numpy(jstate["params"], "cpu"),
              "opt": opt_state_from_numpy(jstate["opt"], "cpu")}
    np.testing.assert_array_equal(
        egnn_params_to_numpy(tstate["params"])["layers"]["phi_e"]["w0"],
        jstate["params"]["layers"]["phi_e"]["w0"])
    ckpt.save(str(tmp_path / "port"), 2, tstate, mesh_shape=(1, 1))
    jckpt.save(str(tmp_path / "jax"), 2, jstate, mesh_shape=(1, 1))
    a, b = tmp_path / "port" / "step_000000002", tmp_path / "jax" / \
        "step_000000002"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jstate)
    got, _ = jckpt.restore_latest(str(tmp_path / "port"), like)
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(
        np.asarray(x), np.asarray(y)), got, jstate)
    assert jnp.asarray(got["opt"]["count"]).dtype == jnp.int32
