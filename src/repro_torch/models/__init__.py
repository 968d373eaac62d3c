"""Model zoo of the port: the LM transformer family, the recsys
architectures and EGNN."""

from . import egnn, recsys, transformer
from .egnn import EGNNConfig
from .recsys import RecsysConfig
from .transformer import LMConfig

__all__ = ["egnn", "recsys", "transformer", "EGNNConfig", "LMConfig",
           "RecsysConfig"]
