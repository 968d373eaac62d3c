"""Typed error taxonomy for the serving stack.

Every failure the serving API can surface derives from :class:`RetrievalError`
so callers catch ONE base class instead of fishing bare ``ValueError``s out
of the retriever, the planner and the kernels. Each subclass also inherits
the builtin exception it shadows (``ValueError`` for query/config misuse,
``RuntimeError`` for runtime faults) so ``except ValueError`` call sites
keep working.

* :class:`InvalidQueryError`     — malformed client input (out-of-range or
  negative token ids, non-integral dtypes, NaN) that ``on_invalid="raise"``
  surfaces instead of sanitizing.
* :class:`ResidencyError`        — device-resident state is missing (no
  GPU, or a retriever built without the needed layout).
* :class:`ScoreIntegrityError`   — the returned ``[B, k]`` score board
  failed the cheap finite-check (NaN/Inf tiles from a bad kernel launch).
* :class:`RetrievalConfigError`  — incompatible constructor arguments
  (unknown regime/gather/plan modes, and modes not yet ported).

The reference's snapshot, front-end and overload errors come with the
slices that port those layers.
"""

from __future__ import annotations


class RetrievalError(Exception):
    """Base class for every typed serving failure."""


class InvalidQueryError(RetrievalError, ValueError):
    """Client query batch is malformed (bad token ids, dtype, or shape)."""


class ResidencyError(RetrievalError, RuntimeError, ValueError):
    """Device-resident index state is missing or failed to upload.

    Also inherits ``ValueError``: the raises it replaced (asking a
    retriever built without a layout to use it) historically surfaced as
    ``ValueError``, and existing callers catch that.
    """


class ScoreIntegrityError(RetrievalError, RuntimeError):
    """The top-k score board contains non-finite entries."""


class RetrievalConfigError(RetrievalError, ValueError):
    """Incompatible or unknown retriever construction arguments."""


__all__ = [
    "RetrievalError", "InvalidQueryError", "ResidencyError",
    "ScoreIntegrityError", "RetrievalConfigError",
]
