"""Fault-tolerant training loop, ported from ``src/repro/train/loop.py``.

* step-atomic checkpoint/restart via :mod:`repro_torch.train.checkpoint`
  (write-to-temp + rename, resume from LATEST);
* deterministic data replay: ``batch_fn(step)`` is a function of the step,
  so a restart replays the exact same batch order and no state beyond the
  step counter needs to be saved;
* failure injection for tests (``fail_at``): a mid-run crash *after* the
  optimizer update but *before* (or after) the checkpoint, covering both
  the loss-of-work and the clean-resume paths;
* ``metrics["step_time"]`` (host seconds from the batch to the step's
  metrics read back, which waits for the device) makes per-step jitter
  observable.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.train import checkpoint as ckpt


class InjectedFailure(RuntimeError):
    """Raised by the failure-injection hook (tests / chaos drills)."""


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    fail_at: Optional[int] = None      # inject a crash after this step
    fail_before_ckpt: bool = True      # crash before the step is saved


def train_loop(step_fn: Callable, params: Any, opt_state: Any,
               batch_fn: Callable[[int], Any], cfg: LoopConfig,
               *, mesh_shape: Optional[tuple] = None,
               log: Callable[[str], None] = print) -> tuple:
    """Run ``step_fn(params, opt_state, batch) -> ((params, opt_state),
    metrics)`` for ``cfg.total_steps``, resuming from the newest complete
    checkpoint if one exists (the restored leaves land on the devices of
    ``params`` and ``opt_state``).

    ``batch_fn(step)`` must be deterministic in ``step``: that is the whole
    fault-tolerance contract, state = (params, opt_state, step).
    """
    start = 0
    if cfg.ckpt_dir:
        restored, manifest = ckpt.restore_latest(
            cfg.ckpt_dir, {"params": params, "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = manifest["step"] + 1
            log(f"[loop] resumed from step {manifest['step']}")
    history = []
    for step in range(start, cfg.total_steps):
        t0 = time.time()
        batch = batch_fn(step)
        (params, opt_state), metrics = step_fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step"] = step
        metrics["step_time"] = time.time() - t0
        history.append(metrics)
        if cfg.log_every and step % cfg.log_every == 0:
            log(f"[loop] step {step}: loss={metrics.get('loss', float('nan')):.4f} "
                f"({metrics['step_time']*1e3:.0f} ms)")
        if (cfg.fail_at is not None and step == cfg.fail_at
                and cfg.fail_before_ckpt):
            raise InjectedFailure(f"injected failure at step {step}")
        if cfg.ckpt_dir and (step % cfg.ckpt_every == 0
                             or step == cfg.total_steps - 1):
            ckpt.save(cfg.ckpt_dir, step,
                      {"params": params, "opt": opt_state},
                      mesh_shape=mesh_shape, keep=cfg.keep)
        if (cfg.fail_at is not None and step == cfg.fail_at
                and not cfg.fail_before_ckpt):
            raise InjectedFailure(f"injected failure at step {step}")
    return (params, opt_state), history
