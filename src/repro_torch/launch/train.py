"""Training launcher, ported from ``src/repro/launch/train.py``:
``python -m repro_torch.launch.train --arch <id> [...]``.

Runs a REDUCED LM, GNN or recsys config end to end (checkpoints,
resume, failure injection, deterministic data replay) on the card unless
``--device cpu`` is given; an LM trains on ``lm_synthetic_batch_fn``'s
stream at ``--seq`` tokens a sequence, EGNN on subgraphs sampled at
fanouts (5, 5) around ``--batch`` seeds of a 2,000-node geometric graph
(:func:`gnn_trainer`, which also builds the ``minibatch_lg`` cell's
trainer at its published width).

:func:`train_batch_trainer` builds the ``train_batch`` cell at a model's
published width: the MLPerf optimizer split of the JAX package's
``launch/cells.py`` (stateless SGD on the embedding tables, AdamW on the
dense towers) over batches of 65,536 from ``CriteoLikeStream``.
"""
from __future__ import annotations

import argparse
import time


class StepBatches:
    """``batch_fn(step)``: the stream's batch at ``step`` as tensors on
    ``device``, made once and kept on the device, so a rerun of a step in
    the same process (a resume, a comparison) takes the same batch without
    making it again.  ``host_s[step]`` is the seconds the host took to make
    it.  Nothing is evicted: the cache is for runs of a few steps."""

    def __init__(self, make, device):
        self.make = make
        self.device = device
        self.cache: dict = {}
        self.host_s: dict = {}

    def __call__(self, step: int) -> dict:
        batch = self.cache.get(step)
        if batch is None:
            from repro_torch.models.recsys import as_tensors

            t0 = time.perf_counter()
            host = self.make(step)
            self.host_s[step] = time.perf_counter() - t0
            batch = self.cache[step] = as_tensors(host, self.device)
        return batch


def mlperf_label(path, leaf) -> str:
    """The MLPerf DLRM split: ``embed`` for the embedding tables (``table``
    and DeepFM's first-order ``fm_w``), ``dense`` for the rest."""
    return "embed" if path and path[0] in ("table", "fm_w") else "dense"


def _recsys_trainer(cfg, opt, batch: int, seed: int, device,
                    microbatches: int = 1, cache: bool = False):
    import torch

    from repro_torch.data.recsys import CriteoLikeStream
    from repro_torch.models import recsys as R
    from repro_torch.train.steps import make_train_step

    gen = torch.Generator(device=device).manual_seed(seed)
    params = R.init_params(cfg, gen, device).params()
    step = make_train_step(lambda p, b: R.loss_fn(p, b, cfg), opt,
                           microbatches)
    stream = CriteoLikeStream(cfg, seed=seed)
    if cache:
        batch_fn = StepBatches(lambda s: stream.batch(s, batch), device)
    else:
        def batch_fn(s):
            return R.as_tensors(stream.batch(s, batch), device)
    return step, params, opt.init(params), batch_fn


def _lm_trainer(cfg, opt, batch: int, seq: int, seed: int, device,
                microbatches: int = 1):
    import torch

    from repro_torch.data.pipeline import lm_synthetic_batch_fn
    from repro_torch.models import transformer as T
    from repro_torch.models.recsys import as_tensors
    from repro_torch.train.steps import make_train_step

    gen = torch.Generator(device=device).manual_seed(seed)
    params = T.init_params(cfg, gen, device).params()
    step = make_train_step(lambda p, b: T.loss_fn(p, b, cfg), opt,
                           microbatches)
    stream = lm_synthetic_batch_fn(cfg.vocab, batch, seq, seed)
    return step, params, opt.init(params), \
        lambda s: as_tensors(stream(s), device)


def gnn_trainer(cfg, opt, graph, feats, labels, coords, batch: int,
                fanouts, seed: int = 0):
    """(step, params, opt_state, batch_fn) of EGNN ``cfg`` under ``opt`` on
    subgraphs of ``graph`` (a ``CSRGraph`` or ``GraphTensors``), on the
    device of ``feats``: weights from a ``torch.Generator`` seeded
    ``seed`` there; step ``s``'s batch samples ``batch`` seeds drawn by
    ``numpy.random.default_rng((seed, s))`` at ``fanouts`` with a
    generator seeded ``s`` (``data.graphs.subgraph_batch``), so that it
    is a function of ``s`` alone."""
    import numpy as np
    import torch

    from repro_torch.data.graphs import subgraph_batch
    from repro_torch.models import egnn as E
    from repro_torch.train.steps import make_train_step

    device = feats.device
    params = E.init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device)
    step = make_train_step(lambda p, b: E.loss_fn(p, b, cfg), opt)

    def batch_fn(s):
        seeds = np.random.default_rng((seed, s)).integers(
            0, graph.n_nodes, size=batch).astype(np.int32)
        gen = torch.Generator(device=device).manual_seed(s)
        return subgraph_batch(graph, feats, labels, seeds, gen,
                              tuple(fanouts), coords=coords)

    return step, params, opt.init(params), batch_fn


def _gnn_reduced_trainer(cfg, opt, batch: int, seed: int, device):
    """The JAX launcher's GNN set-up: a 2,000-node geometric graph (k=8),
    normal features, labels from the signs of the first two coordinates,
    fanouts (5, 5)."""
    import numpy as np
    import torch

    from repro_torch.data.graphs import random_geometric_graph

    g, coords = random_geometric_graph(2000, 8, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(2000, cfg.d_feat)).astype(np.float32)
    labels = (coords[:, 0] > 0).astype(np.int32) + 2 * (
        coords[:, 1] > 0).astype(np.int32)
    return gnn_trainer(cfg, opt, g, torch.tensor(feats, device=device),
                       torch.tensor(labels, device=device),
                       torch.tensor(coords, device=device), batch, (5, 5),
                       seed)


def build_reduced_trainer(arch: str, batch: int, seq: int = 64,
                          seed: int = 0, device="cuda",
                          microbatches: int = 1):
    """(step, params, opt_state, batch_fn) of the reduced config of an LM,
    GNN or recsys ``arch`` under AdamW with a cosine schedule; an LM's
    batches hold ``batch`` sequences of ``seq`` tokens, a GNN's the
    subgraphs of ``batch`` seeds.  ``batch_fn`` makes each batch when it
    is asked for and keeps none."""
    from repro_torch.configs import get_arch
    from repro_torch.train.optimizer import adamw, cosine_schedule

    spec = get_arch(arch)
    cfg = spec.reduced()
    opt = adamw(cosine_schedule(3e-3, warmup=20, total=500))
    if spec.family == "lm":
        return _lm_trainer(cfg, opt, batch, seq, seed, device, microbatches)
    if spec.family == "gnn":
        if microbatches > 1:
            raise ValueError("a GNN batch is one graph: it does not split "
                             "into microbatches")
        return _gnn_reduced_trainer(cfg, opt, batch, seed, device)
    return _recsys_trainer(cfg, opt, batch, seed, device, microbatches)


def train_batch_trainer(arch: str, device="cuda", seed: int = 0,
                        batch: int | None = None, cfg=None):
    """(step, params, opt_state, batch_fn) of the ``train_batch`` cell:
    the published config (or ``cfg``), its batch of 65,536 (or ``batch``),
    and the MLPerf split ``partitioned(mlperf_label, {"embed": sgd(0.05),
    "dense": adamw(1e-3)})``.  ``batch_fn`` is a :class:`StepBatches`,
    which keeps every batch it makes on the device."""
    from repro_torch.configs import get_arch
    from repro_torch.train.optimizer import adamw, partitioned, sgd

    spec = get_arch(arch)
    cfg = cfg or spec.model
    batch = batch or spec.cell("train_batch")["batch"]
    opt = partitioned(mlperf_label, {"embed": sgd(0.05),
                                     "dense": adamw(1e-3)})
    return _recsys_trainer(cfg, opt, batch, seed, device, cache=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64,
                    help="tokens a sequence (LM archs)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model trains on")
    args = ap.parse_args(argv)

    from repro_torch.train.loop import LoopConfig, train_loop

    step, params, opt_state, batch_fn = build_reduced_trainer(
        args.arch, args.batch, args.seq, device=args.device,
        microbatches=args.microbatches)
    cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, fail_at=args.fail_at)
    (_, _), history = train_loop(step, params, opt_state, batch_fn, cfg)
    print(f"final loss: {history[-1]['loss']:.4f} "
          f"(first: {history[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
