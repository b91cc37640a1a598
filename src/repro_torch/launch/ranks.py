"""Process groups on one host: the port's stand-in for running a
``shard_map`` program over several devices of one process.

* :func:`process_group` joins this process to a group (world size 1 by
  default) that meets through a file in a temporary directory, and
  destroys the group on every exit path;
* :func:`spawn_ranks` runs ``fn(rank, world_size, *args)`` on
  ``world_size`` fresh processes (``spawn``, never ``fork``: the caller
  may have CUDA up), each in the group, and returns their results in
  rank order.  A rank that raises or exits non-zero, or a run past
  ``timeout_s``, stops every rank and raises :class:`RankFailed`; nothing
  is retried.

Each rank runs its torch work on one intra-op thread, and ``fn`` and its
arguments must pickle (a module-level function and host data: a CUDA
tensor cannot cross).  Results travel back through ``torch.save`` files
that only these ranks write.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Callable, Optional, Sequence


class RankFailed(RuntimeError):
    """A rank raised, exited non-zero, or outlived the timeout."""


@contextlib.contextmanager
def process_group(backend: str, *, rank: int = 0, world_size: int = 1,
                  init_file: Optional[str] = None,
                  timeout_s: float = 300.0):
    """``init_process_group`` through ``file://init_file`` (a fresh file
    in a temporary directory when None), ``destroy_process_group`` on
    exit.  A collective that waits past ``timeout_s`` raises."""
    import torch.distributed as dist

    with contextlib.ExitStack() as stack:
        if init_file is None:
            tmp = stack.enter_context(tempfile.TemporaryDirectory(
                prefix="repro_pg_"))
            init_file = os.path.join(tmp, "store")
        dist.init_process_group(
            backend, init_method="file://" + init_file, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(rank, world_size, backend, out_dir, timeout_s, fn, args):
    import torch

    torch.set_num_threads(1)
    try:
        with process_group(backend, rank=rank, world_size=world_size,
                           init_file=os.path.join(out_dir, "store"),
                           timeout_s=timeout_s):
            result = fn(rank, world_size, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _failure(out_dir: str, rank: int, what: str) -> RankFailed:
    path = os.path.join(out_dir, f"rank{rank}.err")
    tb = open(path).read() if os.path.exists(path) else "(no traceback)"
    return RankFailed(f"rank {rank} {what}:\n{tb}")


def spawn_ranks(fn: Callable, world_size: int, args: Sequence = (), *,
                backend: str = "gloo", timeout_s: float = 300.0) -> list:
    """``[fn(r, world_size, *args) for r in range(world_size)]``, each on
    its own process in one ``backend`` group; see the module docstring."""
    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as out_dir:
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(r, world_size, backend, out_dir,
                                   timeout_s, fn, tuple(args)))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout_s
            running = list(procs)
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    late = [procs.index(p) for p in running]
                    raise RankFailed(f"ranks {late} still running after "
                                     f"{timeout_s} s")
                wait([p.sentinel for p in running], timeout=left)
                for p in list(running):
                    if p.exitcode is None:
                        continue
                    running.remove(p)
                    if p.exitcode != 0:
                        raise _failure(out_dir, procs.index(p),
                                       f"exited with code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world_size)]
