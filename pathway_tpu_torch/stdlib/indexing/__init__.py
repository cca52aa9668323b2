"""Live indexes: KNN, BM25 and hybrid behind the index-as-a-join
``DataIndex`` (the port of ``pathway_tpu/stdlib/indexing``; reference:
python/pathway/stdlib/indexing/).

The brute-force KNN helpers take ``device`` (default ``"cuda"``) for the
index they build; the approximate tiers ``IvfKnn`` and ``LshKnn`` (with
their factories and ``default_lsh_knn_document_index``) are host numpy
and take none.
"""

import enum

from .data_index import DataIndex
from .inner_index import (
    BruteForceKnn,
    HybridIndex,
    InnerIndex,
    IvfKnn,
    LshKnn,
    TantivyBM25,
    USearchKnn,
)
from .retrievers import (
    AbstractRetrieverFactory,
    BruteForceKnnFactory,
    HybridIndexFactory,
    IvfKnnFactory,
    LshKnnFactory,
    TantivyBM25Factory,
    UsearchKnnFactory,
)


class BruteForceKnnMetricKind(str, enum.Enum):
    """Metric names for BruteForceKnn (reference: the engine enum of the
    same name); values are the metric strings the factories accept."""

    COS = "cos"
    L2SQ = "l2sq"

    def __str__(self) -> str:  # yaml templates pass the enum through
        return self.value


class USearchMetricKind(str, enum.Enum):
    """Reference USearch metric kinds, mapped onto the metric strings."""

    COS = "cos"
    L2SQ = "l2sq"
    IP = "dot"

    def __str__(self) -> str:
        return self.value


class DefaultKnnFactory(BruteForceKnnFactory):
    """Default KNN factory: BruteForceKnn under the hood (reference:
    nearest_neighbors.py:574)."""


def default_vector_document_index(data_column, data_table, *, embedder=None,
                                  dimensions=None, metadata_column=None,
                                  device="cuda") -> DataIndex:
    factory = BruteForceKnnFactory(dimensions=dimensions, embedder=embedder,
                                   device=device)
    return factory.build_index(data_column, data_table,
                               metadata_column=metadata_column)


def default_brute_force_knn_document_index(
    data_column, data_table, dimensions=None, *, embedder=None,
    metadata_column=None, metric="cos", reserved_space: int = 1024,
    device="cuda",
) -> DataIndex:
    factory = BruteForceKnnFactory(
        dimensions=dimensions, embedder=embedder, metric=str(metric),
        reserved_space=reserved_space, device=device)
    return factory.build_index(data_column, data_table,
                               metadata_column=metadata_column)


def default_lsh_knn_document_index(
    data_column, data_table, *, dimensions=None, embedder=None,
    metadata_column=None,
) -> DataIndex:
    factory = LshKnnFactory(dimensions=dimensions, embedder=embedder)
    return factory.build_index(data_column, data_table,
                               metadata_column=metadata_column)


def default_usearch_knn_document_index(
    data_column, data_table, dimensions=None, *, embedder=None,
    metadata_column=None, metric="cos", reserved_space: int = 1024,
    device="cuda",
) -> DataIndex:
    factory = UsearchKnnFactory(
        dimensions=dimensions, embedder=embedder, metric=str(metric),
        reserved_space=reserved_space, device=device)
    return factory.build_index(data_column, data_table,
                               metadata_column=metadata_column)


def default_full_text_document_index(data_column, data_table, *,
                                     metadata_column=None) -> DataIndex:
    return TantivyBM25Factory().build_index(data_column, data_table,
                                            metadata_column=metadata_column)


__all__ = [
    "DataIndex", "InnerIndex", "BruteForceKnn", "USearchKnn", "IvfKnn",
    "LshKnn", "TantivyBM25", "HybridIndex", "AbstractRetrieverFactory",
    "BruteForceKnnFactory", "IvfKnnFactory", "UsearchKnnFactory",
    "LshKnnFactory", "TantivyBM25Factory", "HybridIndexFactory",
    "DefaultKnnFactory", "BruteForceKnnMetricKind", "USearchMetricKind",
    "default_vector_document_index", "default_full_text_document_index",
    "default_brute_force_knn_document_index",
    "default_lsh_knn_document_index", "default_usearch_knn_document_index",
]
