"""ML stdlib (the port of ``pathway_tpu/stdlib/ml``; reference:
python/pathway/stdlib/ml/): the classic ``KNNIndex`` API and the kNN LSH
classifier.  ``hmm``, ``smart_table_ops``, ``datasets`` and ``utils`` are
not ported."""

from . import classifiers, index
from .index import KNNIndex

__all__ = ["KNNIndex", "index", "classifiers"]
