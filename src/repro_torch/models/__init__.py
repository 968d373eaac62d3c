"""Model zoo of the port: the LM transformer family and the recsys
architectures.

The reference's ``repro.models`` also holds EGNN; it comes with its
slice.
"""

from . import recsys, transformer
from .recsys import RecsysConfig
from .transformer import LMConfig

__all__ = ["recsys", "transformer", "LMConfig", "RecsysConfig"]
