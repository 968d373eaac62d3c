"""Distribution layer: logical-axis sharding helpers (see ``sharding.py``)."""

from .sharding import (activation_sharding, batch_pspec, constrain, data_axes,
                       dp_spmd_axes, param_pspecs, spec_placements)

__all__ = ["activation_sharding", "batch_pspec", "constrain", "data_axes",
           "dp_spmd_axes", "param_pspecs", "spec_placements"]
