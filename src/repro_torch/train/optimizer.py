"""Optax-style optimizers over nested dicts of tensors, ported from
``src/repro/train/optimizer.py``.

An Optimizer is (init, update):
  state  = opt.init(params)
  updates, state = opt.update(grads, state, params)
  params = apply_updates(params, updates)

The state keeps the JAX package's layout, so it checkpoints under the same
keys: ``count`` is a 0-d int32 tensor and ``mu`` / ``nu`` / ``mom`` are
float32 trees in the structure of the parameters.  The step counter, the
bias corrections ``b1 ** count`` / ``b2 ** count`` and the schedules are
computed in float32 tensors on the parameters' device, as JAX computes
them (Python float64 arithmetic would shift each update in its last bits).
``torch.optim.AdamW`` is not used: it orders the decay and the bias
correction differently and keeps no ``count`` leaf.

``partitioned`` routes different parameter subtrees to different
optimizers via a label function; an optimizer keeps state *only* for its
own leaves (a leaf labelled for another is absent from its trees, not
zero), so MLPerf-style recsys training holds no AdamW moments for the
embedding tables.

Unlike the JAX package, :func:`apply_updates` adds in place (under
``torch.no_grad()``): the counterpart of JAX's donated buffers, so a
2 GB table is not copied each step.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.train import tree as T


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


@torch.no_grad()
def apply_updates(params, updates):
    """``p += u`` for every leaf, in place (the sum rounded to ``p``'s type,
    as JAX's ``(p + u).astype(p.dtype)``); returns ``params``."""
    T.tree_map(lambda p, u: p.add_(u), params, updates)
    return params


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in T.leaves(tree)]
    if not sq:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(grads, max_norm: float) -> torch.Tensor:
    g = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp_min(g, 1e-9), max=1.0)


def clip_by_global_norm(max_norm: float):
    def init(params):
        return ()

    def update(grads, state, params=None):
        scale = _clip_scale(grads, max_norm)
        return T.tree_map(lambda x: x * scale, grads), state

    return Optimizer(init, update)


def _device(tree):
    leaves = T.leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _count0(tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device(tree))


def sgd(lr: float | Callable = 1e-2, momentum: float = 0.0):
    def init(params):
        if momentum == 0.0:
            return {"count": _count0(params)}
        return {"count": _count0(params),
                "mom": T.tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        count = state["count"] + 1
        cur_lr = lr(count) if callable(lr) else lr
        if momentum == 0.0:
            upd = T.tree_map(lambda g: -cur_lr * g, grads)
            return upd, {"count": count}
        mom = T.tree_map(lambda m, g: momentum * m + g, state["mom"], grads)
        upd = T.tree_map(lambda m: -cur_lr * m, mom)
        return upd, {"count": count, "mom": mom}

    return Optimizer(init, update)


def adamw(lr: float | Callable = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: Optional[float] = 1.0):
    """AdamW with optional fused global-norm clipping."""

    def zeros32(p):
        return torch.zeros_like(p, dtype=torch.float32)

    def init(params):
        return {"count": _count0(params),
                "mu": T.tree_map(zeros32, params),
                "nu": T.tree_map(zeros32, params)}

    def update(grads, state, params):
        if clip_norm is not None:
            scale = _clip_scale(grads, clip_norm)
            grads = T.tree_map(lambda x: x * scale, grads)
        count = state["count"] + 1
        cur_lr = lr(count) if callable(lr) else lr
        mu = T.tree_map(
            lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
            state["mu"], grads)
        nu = T.tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
            state["nu"], grads)
        c = count.to(torch.float32)
        mu_hat_scale = 1.0 / (1 - b1 ** c)
        nu_hat_scale = 1.0 / (1 - b2 ** c)

        def upd(m, v, p):
            step = m * mu_hat_scale / (torch.sqrt(v * nu_hat_scale) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(torch.float32)
            return (-cur_lr * step).to(torch.float32)

        updates = T.tree_map(upd, mu, nu, params)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def _masked(node, lab, key):
    if isinstance(node, dict):
        out = {}
        for k, child in node.items():
            sub = _masked(child, lab[k], key)
            if sub is not None:
                out[k] = sub
        return out or None
    return node if lab == key else None


def _mask(tree, labels, key):
    """The leaves of ``tree`` labelled ``key``; every other leaf, and every
    dict left empty, is absent."""
    return _masked(tree, labels, key) or {}


def partitioned(label_fn: Callable, optimizers: dict[str, Optimizer]):
    """Route param subtrees to optimizers by label.

    ``label_fn(path, leaf)`` -> key into ``optimizers``; ``path`` is the
    tuple of dict keys from the root (``("table",)``, ``("top_mlp",
    "w0")``).  Each optimizer sees only its own leaves and keeps state only
    for them."""

    def _labels(params):
        return T.map_with_path(lambda path, leaf: label_fn(path, leaf),
                               params)

    def init(params):
        labels = _labels(params)
        return {key: opt.init(_mask(params, labels, key))
                for key, opt in optimizers.items()}

    def update(grads, state, params):
        labels = _labels(grads)
        new_state, upds = {}, {}
        for key, opt in optimizers.items():
            upds[key], new_state[key] = opt.update(
                _mask(grads, labels, key), state[key],
                _mask(params, labels, key))
        # stitch the per-leaf updates back together by path
        total = T.map_with_path(
            lambda path, _g: T.get(upds[T.get(labels, path)], path), grads)
        return total, new_state

    return Optimizer(init, update)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warm-up to ``peak_lr``, then a cosine decay to ``floor`` times
    it; ``lr(step)`` takes the int32 step count and returns a float32 0-d
    tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr
