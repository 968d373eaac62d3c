"""EGNN [arXiv:2102.09844]: n_layers=4, d_hidden=64, E(n)-equivariant.

Four assigned shapes spanning the GNN kernel regimes:
  full_graph_sm — Cora (2,708 nodes / 10,556 edges / 1,433 features)
  minibatch_lg  — Reddit (232,965 nodes) with a real fanout-(15,10)
                  neighbor sampler (data/graphs.py); fixed-shape subgraph
  ogb_products  — 2,449,029 nodes / 61,859,140 edges, full-batch
  molecule      — 128 small graphs (30 nodes / 64 edges), graph regression

Cora/Reddit/products carry no native 3-D geometry; EGNN receives synthetic
coordinates (the arch is assigned to these shapes by the pool — the
equivariant path is exercised, geometry is procedural). Edge arrays are
sharded over the full mesh; nodes replicate.
"""

from dataclasses import replace

from ..models.egnn import EGNNConfig, reduced
from .common import Cell, gnn_train_cell

CONFIG = EGNNConfig(name="egnn", n_layers=4, d_hidden=64, d_feat=64, n_out=1)

SMOKE = reduced(CONFIG, d_feat=8, n_out=3)

FAMILY = "gnn"

# seeds=1024, fanout (15, 10): 1024 + 15,360 + 153,600 sampled nodes
_MINIBATCH_NODES = 1024 + 1024 * 15 + 1024 * 15 * 10
_MINIBATCH_EDGES = 1024 * 15 + 1024 * 15 * 10

SHAPE_DEFS = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_out=7),
    "minibatch_lg": dict(n_nodes=_MINIBATCH_NODES, n_edges=_MINIBATCH_EDGES,
                         d_feat=602, n_out=41),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                         n_out=47),
    "molecule": dict(n_nodes=128 * 30, n_edges=128 * 64, d_feat=11, n_out=1,
                     n_graphs=128),
}


def shape_config(shape: str) -> EGNNConfig:
    """``CONFIG`` at one shape's input and output widths and readout."""
    d = SHAPE_DEFS[shape]
    return replace(CONFIG, d_feat=d["d_feat"], n_out=d["n_out"],
                   readout="graph" if shape == "molecule" else "node")


def cells() -> list[Cell]:
    out = []
    for shape, d in SHAPE_DEFS.items():
        out.append(gnn_train_cell(
            "egnn", shape_config(shape), shape, n_nodes=d["n_nodes"],
            n_edges=d["n_edges"], n_graphs=d.get("n_graphs"),
            note="neighbor-sampled" if shape == "minibatch_lg" else ""))
    return out
