"""Procedural graphs + a real neighbor sampler (GNN data pipeline).

A numpy copy of ``repro.data.graphs`` (the port imports nothing of the JAX
package): for a given seed every array is byte-identical to the
reference's. Only ``Graph.csr`` sorts with torch, for speed.

``neighbor_sample`` implements GraphSAGE-style layered fanout sampling over
a CSR adjacency — the ``minibatch_lg`` shape requires it. Output shapes are
STATIC (padded with -1 edges / repeated nodes) so the jitted train step
never recompiles across batches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Graph:
    n_nodes: int
    edges: np.ndarray          # [E, 2] int64 (src, dst)
    node_feat: np.ndarray      # [N, F] float32
    coords: np.ndarray         # [N, 3] float32
    labels: np.ndarray         # [N] int64

    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """In-neighbor CSR: (indptr [N+1], src indices [E]) keyed by dst.

        The order is ``np.argsort(dst, kind="stable")``'s, taken from
        torch's stable sort on the CPU (a radix sort, several times faster
        on graphs of 10^8 edges).
        """
        dst = torch.from_numpy(np.ascontiguousarray(self.edges[:, 1]))
        order = torch.sort(dst, stable=True).indices.numpy()
        dst_sorted = self.edges[order, 1]
        src_sorted = self.edges[order, 0]
        indptr = np.zeros(self.n_nodes + 1, dtype=np.int64)
        np.add.at(indptr, dst_sorted + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, src_sorted


def random_graph(n_nodes: int, avg_degree: int, *, d_feat: int,
                 n_classes: int, seed: int = 0) -> Graph:
    """Power-lawish random graph with feature-correlated labels."""
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * avg_degree
    # preferential-attachment-flavored endpoints (power-law in-degree)
    dst = (n_nodes * rng.power(3.0, n_edges)).astype(np.int64) % n_nodes
    src = rng.integers(0, n_nodes, size=n_edges)
    labels = rng.integers(0, n_classes, size=n_nodes)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feat = centers[labels] + rng.normal(
        scale=2.0, size=(n_nodes, d_feat)).astype(np.float32)
    coords = rng.normal(size=(n_nodes, 3)).astype(np.float32)
    return Graph(n_nodes, np.stack([src, dst], 1), feat, coords, labels)


def fanout_bags(indptr: np.ndarray, src_idx: np.ndarray, nodes, fanout: int,
                *, rng: np.random.Generator) -> np.ndarray:
    """One hop of ``neighbor_sample``'s rule as bags of global node ids.

    For each node ``u`` of ``nodes``, ``k = min(fanout, in-degree)``
    in-neighbours drawn without replacement from its row of the CSR
    ``(indptr, src_idx)`` (``Graph.csr()``); the rest of its row of the
    ``[len(nodes), fanout]`` int32 result is ``-1``, and so is the whole
    row of a node ``-1``. ``rng`` is drawn once for each node with an
    in-neighbour, in order, as ``neighbor_sample`` draws it.
    """
    bags = np.full((len(nodes), fanout), -1, np.int32)
    for i, u in enumerate(nodes):
        u = int(u)
        if u < 0:
            continue
        lo, hi = int(indptr[u]), int(indptr[u + 1])
        if hi == lo:
            continue
        k = min(fanout, hi - lo)
        bags[i, :k] = rng.choice(src_idx[lo:hi], size=k, replace=False)
    return bags


def neighbor_sample(graph: Graph, seeds: np.ndarray, fanouts: tuple[int, ...],
                    *, rng: np.random.Generator) -> dict:
    """Layered fanout sampling -> fixed-shape padded subgraph batch.

    Returns arrays sized for the WORST case (seeds · Π fanouts) regardless
    of actual neighborhood sizes: node_feat/coords [n_max, F], edges
    [e_max, 2] (-1 padded), labels [n_max] with -1 for non-seed nodes.
    """
    indptr, src_idx = graph.csr()
    n_per_layer = [len(seeds)]
    for f in fanouts:
        n_per_layer.append(n_per_layer[-1] * f)
    n_max = sum(n_per_layer)
    e_max = sum(n_per_layer[1:])

    local_of = {int(n): i for i, n in enumerate(seeds)}
    nodes = list(seeds)
    edges = []
    frontier = list(seeds)
    for f in fanouts:
        nxt = []
        bags = fanout_bags(indptr, src_idx, frontier, f, rng=rng)
        for u, bag in zip(frontier, bags):
            picks = bag[bag >= 0]
            for v in picks:
                v = int(v)
                if v not in local_of:
                    local_of[v] = len(nodes)
                    nodes.append(v)
                edges.append((local_of[v], local_of[int(u)]))   # src -> dst
            nxt.extend(int(p) for p in picks)
        frontier = nxt

    nodes = np.asarray(nodes, dtype=np.int64)
    feat = np.zeros((n_max, graph.node_feat.shape[1]), np.float32)
    coords = np.zeros((n_max, 3), np.float32)
    feat[: nodes.size] = graph.node_feat[nodes]
    coords[: nodes.size] = graph.coords[nodes]
    labels = np.full(n_max, -1, dtype=np.int32)
    labels[: len(seeds)] = graph.labels[seeds]
    e = np.full((e_max, 2), -1, dtype=np.int32)
    if edges:
        e[: len(edges)] = np.asarray(edges, dtype=np.int32)
    return {"node_feat": feat, "coords": coords, "edges": e,
            "labels": labels}


def batched_molecules(n_graphs: int, *, n_nodes: int = 30, n_edges: int = 64,
                      d_feat: int = 11, seed: int = 0) -> dict:
    """Flatten a batch of small molecule-like graphs + regression targets.

    Target = a smooth function of geometry (sum of pairwise 1/r over edges)
    so the EGNN objective is learnable and rotation-invariant.
    """
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n_graphs * n_nodes, d_feat)).astype(np.float32)
    coords = rng.normal(size=(n_graphs * n_nodes, 3)).astype(np.float32)
    edges = []
    targets = np.zeros((n_graphs, 1), np.float32)
    for g in range(n_graphs):
        off = g * n_nodes
        src = rng.integers(0, n_nodes, size=n_edges)
        dst = (src + 1 + rng.integers(0, n_nodes - 1, size=n_edges)) % n_nodes
        edges.append(np.stack([src + off, dst + off], 1))
        d = np.linalg.norm(coords[src + off] - coords[dst + off], axis=1)
        targets[g, 0] = float((1.0 / (1.0 + d)).sum())
    graph_ids = np.repeat(np.arange(n_graphs, dtype=np.int32), n_nodes)
    return {"node_feat": feat, "coords": coords,
            "edges": np.concatenate(edges).astype(np.int32),
            "graph_ids": graph_ids, "n_graphs": n_graphs,
            "targets": targets}
