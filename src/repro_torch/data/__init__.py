"""Synthetic data of the port (numpy, copied from the JAX package):
procedural graphs and the neighbor sampler that the sparse substrate's
graph shapes are drawn from."""

from .graphs import Graph, batched_molecules, neighbor_sample, random_graph

__all__ = ["Graph", "batched_molecules", "neighbor_sample", "random_graph"]
