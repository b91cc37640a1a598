"""Random even-regular undirected graphs.

The starting point of the paper's Fig. 7-left experiment: Algorithm 5 turns a
*random* even-regular graph into a competitive search graph purely through
continuous edge optimization.  Construction: a union of d/2 independent random
Hamiltonian cycles — each cycle contributes degree 2 to every vertex and is
itself connected, so the union is d-regular and connected by construction.
Duplicate edges between cycles are repaired with 2-opt rotations.  The host
loops are the JAX package's, line for line, so one seed gives one graph in
both packages.
"""
from __future__ import annotations

import numpy as np

from ..build import DEGIndex, DEGParams, np_pair_dist
from ..graph import GraphBuilder


def random_regular_graph(n: int, degree: int, rng: np.random.Generator,
                         vectors: np.ndarray | None = None,
                         metric: str = "l2", device="cuda") -> GraphBuilder:
    if degree % 2 != 0 or degree < 4:
        raise ValueError("degree must be even and >= 4")
    if n < degree + 2:
        raise ValueError("need n >= degree + 2")
    b = GraphBuilder(n, degree, device)
    for _ in range(n):
        b.add_vertex()
    edges: set[tuple[int, int]] = set()

    def key(u, v):
        return (u, v) if u < v else (v, u)

    for _ in range(degree // 2):
        cyc = None
        for attempt in range(256):
            perm = [int(x) for x in rng.permutation(n)]
            # 2-opt repair: if (perm[i], perm[i+1]) collides with an existing
            # edge, reverse the segment after i+j for a random j — changes two
            # cycle edges, keeps it a single Hamiltonian cycle.
            ok = True
            for _rep in range(8 * n):
                bad = next((i for i in range(n)
                            if key(perm[i], perm[(i + 1) % n]) in edges), None)
                if bad is None:
                    break
                j = int(rng.integers(2, n - 1))
                lo, hi = (bad + 1) % n, (bad + j) % n
                if lo < hi:
                    perm[lo : hi + 1] = perm[lo : hi + 1][::-1]
                else:
                    perm = perm[lo:] + perm[:lo]
                    perm[: j + 1] = perm[: j + 1][::-1]
            else:
                ok = False
            if not ok:
                continue
            cyc = [key(perm[i], perm[(i + 1) % n]) for i in range(n)]
            if len(set(cyc)) == n and not (set(cyc) & edges):
                break
            cyc = None
        if cyc is None:
            raise RuntimeError("could not draw a disjoint Hamiltonian cycle")
        edges.update(cyc)
        for u, v in cyc:
            w = 0.0
            if vectors is not None:
                w = float(np_pair_dist(metric, vectors[u], vectors[v])[0])
            b.add_edge(u, v, w)
    return b


def random_regular_index(vectors: np.ndarray, params: DEGParams,
                         seed: int = 0, device="cuda") -> DEGIndex:
    """A DEGIndex whose graph is random-regular (Fig. 7-left protocol):
    same search / refine machinery, garbage edges."""
    vectors = np.asarray(vectors, dtype=np.float32)
    n = vectors.shape[0]
    rng = np.random.default_rng(seed)
    idx = DEGIndex(vectors.shape[1], params, capacity=n, device=device)
    idx.vectors[:n] = vectors
    idx._put_rows(vectors, 0)
    idx.builder = random_regular_graph(n, params.degree, rng, vectors,
                                       params.metric, device)
    return idx
