"""ML stdlib (the port of ``pathway_tpu/stdlib/ml``; reference:
python/pathway/stdlib/ml/): the classic ``KNNIndex`` API, the kNN LSH
classifier, the smart fuzzy join, the HMM reducer, datasets and utils."""

from . import classifiers, datasets, hmm, index, smart_table_ops, utils
from .index import KNNIndex

__all__ = ["KNNIndex", "index", "classifiers", "smart_table_ops", "hmm",
           "datasets", "utils"]
