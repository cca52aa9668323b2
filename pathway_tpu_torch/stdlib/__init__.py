"""The port of ``pathway_tpu/stdlib``: indexing, ml (``KNNIndex`` and the
kNN LSH classifier), temporal, ordered, statistical, stateful and utils.
``graphs``, ``viz`` and ml's ``hmm``, ``smart_table_ops``, ``datasets``
and ``utils`` are not ported."""

from . import indexing, ml, ordered, stateful, statistical, temporal, utils

__all__ = ["indexing", "ml", "ordered", "stateful", "statistical", "temporal",
           "utils"]
