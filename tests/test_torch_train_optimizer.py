"""The port's optimizers (``repro_torch.train.optimizer``) against the JAX
package's on the CPU: the same seeded gradient trees go through both for
5 steps, and every step's updates and state must agree.

Tolerance: updates, parameters and float states at rtol 1e-6 (float32 on
both sides; XLA may contract a multiply-add into one rounding where torch
rounds twice, and the global norm sums its leaves in another order), with
an atol of 1e-6 times the tree's largest magnitude: an entry near zero
comes out of a cancellation in the moments, which keeps the absolute
error of the tree's scale (the clip scale and the learning rate are
tree-wide) and not a relative one; ``count`` exactly.
The partitioned case is the MLPerf split the ``train_batch`` cell uses,
and its state must hold no moments for the embedding leaves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as J
from repro_torch.interop import opt_state_from_numpy, opt_state_to_numpy
from repro_torch.launch.train import mlperf_label
from repro_torch.train import optimizer as P
from repro_torch.train import tree as T
from _torch_threads import _one_torch_thread  # noqa: F401

RTOL = 1e-6
STEPS = 5
SHAPES = {"table": (12, 4), "fm_w": (12,), "fm_b": (),
          "top_mlp": {"w0": (4, 3), "b0": (3,), "w1": (3, 1), "b1": (1,)}}


def _jax_mlperf_label(path, leaf):
    return ("embed" if path and getattr(path[0], "key", None)
            in ("table", "fm_w") else "dense")


def _tree(rng, scale=1.0, shapes=SHAPES):
    """A float32 tree of ``shapes`` (whose tuples are shapes, not nodes)."""
    return {k: (_tree(rng, scale, v) if isinstance(v, dict) else
                (scale * rng.normal(size=v)).astype(np.float32))
            for k, v in sorted(shapes.items())}


CASES = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd-momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "sgd-cosine": lambda m: m.sgd(m.cosine_schedule(0.5, warmup=2, total=5)),
    "adamw-clip": lambda m: m.adamw(1e-2),
    "adamw-noclip": lambda m: m.adamw(1e-2, clip_norm=None),
    "adamw-decay": lambda m: m.adamw(1e-2, weight_decay=0.1),
    "adamw-cosine": lambda m: m.adamw(m.cosine_schedule(3e-3, warmup=2,
                                                        total=5)),
    "clip": lambda m: m.clip_by_global_norm(1.0),
    "mlperf": lambda m: m.partitioned(
        _jax_mlperf_label if m is J else mlperf_label,
        {"embed": m.sgd(0.05), "dense": m.adamw(1e-3)}),
}


def _np(tree):
    return T.tree_map(lambda x: np.asarray(x), tree)


def _assert_trees(got, want, what):
    g, w = T.leaves_with_path(got), T.leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    scale = max([float(np.abs(np.asarray(b)).max()) for _, b in w
                 if np.asarray(b).dtype.kind == "f" and np.size(b)],
                default=0.0)
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, path)
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * scale,
                                       err_msg=f"{what} {path}")


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_jax(case):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jopt, topt = CASES[case](J), CASES[case](P)
    jp = jax.tree.map(jnp.asarray, params)
    tp = T.tree_map(torch.tensor, params)
    js, ts = jopt.init(jp), topt.init(tp)
    _assert_trees(opt_state_to_numpy(ts, like=js), _np(js), "init")
    for step in range(STEPS):
        # gradients of a norm around 5: the clip scales them
        grads = _tree(rng, scale=0.8)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tu, ts = topt.update(T.tree_map(torch.tensor, grads), ts, tp)
        jp = J.apply_updates(jp, ju)
        tp_again = P.apply_updates(tp, tu)
        assert tp_again is tp                             # in place
        _assert_trees(_np(T.tree_map(lambda x: x.numpy(), tu)), _np(ju),
                      f"updates {step}")
        _assert_trees(opt_state_to_numpy(ts, like=js), _np(js),
                      f"state {step}")
        _assert_trees(T.tree_map(lambda x: x.numpy(), tp), _np(jp),
                      f"params {step}")
    counts = [leaf for path, leaf in T.leaves_with_path(ts)
              if path[-1] == "count"]
    assert all(c.dtype == torch.int32 and int(c) == STEPS for c in counts)


def test_partitioned_keeps_no_moments_for_the_tables():
    """The MLPerf split: SGD's state is its count alone, and AdamW holds
    moments for the dense leaves only (the table and ``fm_w`` absent, not
    zero), as the JAX state holds ``None`` there."""
    params = T.tree_map(torch.tensor, _tree(np.random.default_rng(1)))
    opt = CASES["mlperf"](P)
    state = opt.init(params)
    assert set(state) == {"embed", "dense"}
    assert set(state["embed"]) == {"count"}
    for moment in ("mu", "nu"):
        assert set(state["dense"][moment]) == {"fm_b", "top_mlp"}
    jstate = CASES["mlperf"](J).init(jax.tree.map(jnp.asarray,
                                                  _tree(np.random.default_rng(1))))
    assert jstate["dense"]["mu"]["table"] is None
    keys = [T.key_of(p) for p, _ in T.leaves_with_path(state)]
    jkeys = ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert keys == jkeys


def test_opt_state_round_trip_through_numpy():
    """A JAX state carried into the port and back is the same tree, its
    ``None`` leaves included, and the JAX optimizer takes it."""
    params = jax.tree.map(jnp.asarray, _tree(np.random.default_rng(2)))
    jopt = CASES["mlperf"](J)
    js = jopt.init(params)
    grads = jax.tree.map(jnp.asarray, _tree(np.random.default_rng(3)))
    _, js = jopt.update(grads, js, params)
    ts = opt_state_from_numpy(_np(js), device="cpu")
    assert "table" not in ts["dense"]["mu"]
    back = opt_state_to_numpy(ts, like=js)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(_np(js))
    _assert_trees(back, _np(js), "round trip")
    jopt.update(grads, jax.tree.map(jnp.asarray, back), params)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(4)
    g = _tree(rng, scale=3.0)
    np.testing.assert_allclose(
        float(P.global_norm(T.tree_map(torch.tensor, g))),
        float(J.global_norm(jax.tree.map(jnp.asarray, g))), rtol=RTOL)
    small = _tree(rng, scale=1e-3)                      # under the norm
    tu, _ = P.clip_by_global_norm(1.0).update(
        T.tree_map(torch.tensor, small), ())
    _assert_trees(T.tree_map(lambda x: x.numpy(), tu), small, "unclipped")


@pytest.mark.parametrize("step", [0, 1, 2, 3, 10, 400, 600])
def test_cosine_schedule_matches_jax(step):
    got = P.cosine_schedule(3e-3, warmup=20, total=500)(
        torch.tensor(step, dtype=torch.int32))
    want = J.cosine_schedule(3e-3, warmup=20, total=500)(
        jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
