"""Serving surface of the PyTorch port: the device retriever and its types."""

from .errors import (InvalidQueryError, ResidencyError, RetrievalConfigError,
                     RetrievalError, ScoreIntegrityError)
from .results import PackedBatch, RetrievalResult
from .retrieval_engine import DeviceRetriever

__all__ = ["DeviceRetriever", "InvalidQueryError", "PackedBatch",
           "ResidencyError", "RetrievalConfigError", "RetrievalError",
           "RetrievalResult", "ScoreIntegrityError"]
