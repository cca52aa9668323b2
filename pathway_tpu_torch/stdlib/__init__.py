"""The port of ``pathway_tpu/stdlib``: indexing, temporal, ordered,
statistical, stateful and utils (graphs, ml and viz are not ported)."""

from . import indexing, ordered, stateful, statistical, temporal, utils

__all__ = ["indexing", "ordered", "stateful", "statistical", "temporal",
           "utils"]
