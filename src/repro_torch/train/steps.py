"""Generic train-step factory, ported from ``src/repro/train/steps.py``:
gradients from ``torch.autograd`` + an optimizer, with optional microbatch
gradient accumulation (a Python loop in place of the JAX ``lax.scan``)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.train import tree as T
from repro_torch.train.optimizer import Optimizer, apply_updates


def _grads(loss_fn: Callable, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``.  The loss sees
    detached views of the parameters (the same storage) that require a
    gradient, so plain tensors and frozen parameters train alike; a leaf
    the loss does not reach gets a zero gradient, as under ``jax.grad``."""
    flat = T.leaves(params)
    views = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(T.unflatten(params, views), batch)
        grads = torch.autograd.grad(loss, views, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, T.unflatten(params, grads)


def make_train_step(loss_fn: Callable, opt: Optimizer,
                    microbatches: int = 1):
    """``loss_fn(params, batch) -> (loss, metrics dict)``.

    Returns ``step(params, opt_state, batch) -> ((params, opt_state),
    metrics)``.  ``params`` is updated in place and returned.  With
    ``microbatches > 1`` the batch's leading dim is split and the
    gradients are accumulated in float32, ``acc + g / microbatches`` in
    microbatch order, as the JAX package's scan adds them; the loss and
    the metrics are the microbatches' means.
    """

    def step(params, opt_state, batch):
        if microbatches <= 1:
            loss, metrics, grads = _grads(loss_fn, params, batch)
        else:
            def split(x):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{microbatches} microbatches")
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])

            mb = T.tree_map(split, batch)
            grads = T.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            losses, metricses = [], []
            for i in range(microbatches):
                loss, metrics, g = _grads(
                    loss_fn, params, T.tree_map(lambda x: x[i], mb))
                grads = T.tree_map(
                    lambda a, gi: a + gi.to(torch.float32) / microbatches,
                    grads, g)
                losses.append(loss)
                metricses.append(metrics)
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in metricses]))
                       for k in metricses[0]}
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return (params, opt_state), metrics

    return step


def make_eval_step(loss_fn: Callable):
    @torch.no_grad()
    def step(params, batch):
        loss, metrics = loss_fn(params, batch)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    return step
