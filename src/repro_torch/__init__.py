"""BM25S on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

Host-side layout code is numpy (copied from the JAX package, which stays
the reference); the query path runs on a torch device through hand-written
CUDA kernels (``repro_torch.kernels``), each with a plain torch twin that
the CPU takes. Nothing here imports JAX or the ``repro`` package.
"""
