"""Model zoo of the port: the recsys architectures for now.

The reference's ``repro.models`` also holds the LM transformer family and
EGNN; they come with their slices.
"""

from . import recsys
from .recsys import RecsysConfig

__all__ = ["recsys", "RecsysConfig"]
