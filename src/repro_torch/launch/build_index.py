"""Index-building launcher: ``python -m repro_torch.launch.build_index``.

Builds a DEG over a synthetic dataset (paper Table 3 parameters by default),
optionally runs continuous refinement, reports recall/QPS, and saves the
index with ``--out`` in the persist snapshot format (``DEGIndex.save``),
which ``serve.py --index`` and either package's ``DEGIndex.load`` read.
The index is built on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--degree", type=int, default=20)
    ap.add_argument("--k-ext", type=int, default=40)
    ap.add_argument("--eps-ext", type=float, default=0.3)
    ap.add_argument("--wave", type=int, default=16,
                    help="bulk-build wave size (1 = paper-faithful)")
    ap.add_argument("--refine", type=int, default=0,
                    help="continuous-refinement iterations after build")
    ap.add_argument("--lid", choices=["low", "high"], default="low")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the index is built on")
    args = ap.parse_args(argv)

    from repro_torch.core.build import DEGParams, build_deg
    from repro_torch.core.distances import exact_knn_batched
    from repro_torch.core.invariants import check_invariants
    from repro_torch.core.metrics import recall_at_k
    from repro_torch.data.synthetic import gaussian_mixture, planted_manifold

    gen = gaussian_mixture if args.lid == "low" else planted_manifold
    vecs = gen(args.n + 500, args.dim, seed=args.seed)
    base, queries = vecs[: args.n], vecs[args.n:]

    params = DEGParams(degree=args.degree, k_ext=args.k_ext,
                       eps_ext=args.eps_ext,
                       scheme="C", rng_checks=True)
    t0 = time.time()
    idx = build_deg(base, params, wave_size=args.wave, device=args.device)
    build_s = time.time() - t0
    if args.refine:
        t0 = time.time()
        idx.refine(args.refine, seed=args.seed)
        print(f"refined {args.refine} iterations in {time.time()-t0:.1f}s "
              f"(avg neighbor dist {idx.builder.average_neighbor_distance():.4f})")
    ok, msgs = check_invariants(idx.builder)
    assert ok, msgs
    t0 = time.time()
    res = idx.search(queries, k=10, eps=0.1)
    found = res.ids.cpu().numpy()          # waits for the search
    qps = queries.shape[0] / (time.time() - t0)
    _, gt = exact_knn_batched(queries, base, 10, device=args.device)
    rec = recall_at_k(found, gt)
    print(f"n={args.n} d={args.degree} wave={args.wave}: "
          f"build {build_s:.1f}s, recall@10 {rec:.4f}, {qps:.0f} qps, "
          f"avg-hops {float(res.hops.float().mean()):.1f}")
    if args.out:
        # versioned full-state snapshot (persist/): serve.py warm-starts
        # from this without rebuilding, and the restored index stays mutable
        idx.save(args.out)
        print(f"saved index snapshot to {args.out}")


if __name__ == "__main__":
    main()
