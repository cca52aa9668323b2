"""The port of ``pathway_tpu/stdlib``: graphs, indexing, ml, temporal,
ordered, statistical, stateful and utils.  ``viz`` is not ported
(ROADMAP queue A item 7)."""

from . import graphs, indexing, ml, ordered, stateful, statistical, temporal, utils

__all__ = ["temporal", "indexing", "ml", "graphs", "statistical", "ordered",
           "stateful", "utils"]
