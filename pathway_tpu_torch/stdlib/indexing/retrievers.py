"""Typed retriever factories (reference: stdlib/indexing/retrievers.py +
nearest_neighbors.py:65-574, bm25.py:41, hybrid_index.py:14).

The port of ``pathway_tpu/stdlib/indexing/retrievers.py``.  A factory's
``build_index(data_column, data_table, metadata_column=None)`` returns a
``DataIndex`` whose ``InnerIndex`` is made when the graph is lowered.
The brute-force KNN factories take ``device`` (default ``"cuda"``,
resolved by ``build_index``, so without a card it raises there unless
``device="cpu"``) and give it to the index; ``mesh`` (a
``parallel/mesh.TPMesh``) goes to ``BruteForceKnn(mesh=)``.
``IvfKnnFactory`` and ``LshKnnFactory`` build the host-numpy approximate
indexes and take no device.  Neither index has ``search_batch``, so
``DataIndex`` sends each of their queries to ``search``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..._device import resolve_device
from ...internals.expression import MakeTupleExpression
from ...internals.table import Table
from .data_index import DataIndex
from .inner_index import (BruteForceKnn, HybridIndex, IvfKnn, LshKnn,
                          TantivyBM25, USearchKnn)


class AbstractRetrieverFactory:
    def build_index(self, data_column, data_table: Table,
                    metadata_column=None) -> DataIndex:
        raise NotImplementedError


@dataclasses.dataclass
class BruteForceKnnFactory(AbstractRetrieverFactory):
    dimensions: int | None = None
    reserved_space: int = 1024
    embedder: Callable | None = None
    metric: str = "cos"
    mesh: Any = None  # parallel/mesh.TPMesh: row-sharded search
    mesh_axis: str | None = None
    device: Any = "cuda"

    _index_cls = BruteForceKnn

    def _inner(self) -> Callable[[], BruteForceKnn]:
        """The index constructor, with the device resolved now."""
        cls = type(self)._index_cls
        dim, space, metric = self.dimensions, self.reserved_space, self.metric
        mesh, axis = self.mesh, self.mesh_axis
        device = resolve_device(self.device)

        def factory():
            return cls(dim, reserved_space=space, metric=metric, mesh=mesh,
                       mesh_axis=axis, device=device)

        return factory

    def build_index(self, data_column, data_table, metadata_column=None
                    ) -> DataIndex:
        return DataIndex(data_table, data_column, index_factory=self._inner(),
                         metadata_column=metadata_column,
                         embedder=self.embedder)


@dataclasses.dataclass
class UsearchKnnFactory(BruteForceKnnFactory):
    """The reference's USearch HNSW factory: exact search here."""

    _index_cls = USearchKnn


@dataclasses.dataclass
class IvfKnnFactory(AbstractRetrieverFactory):
    """Scale-tier ANN (``inner_index.IvfKnn``): a coarse quantizer and
    exact rescoring of the probed clusters' rows."""

    dimensions: int | None = None
    n_clusters: int = 256
    nprobe: int = 16
    metric: str = "cos"
    train_min: int = 4096
    reserved_space: int = 1024
    embedder: Callable | None = None

    def build_index(self, data_column, data_table, metadata_column=None
                    ) -> DataIndex:
        dim = self.dimensions
        kw = dict(n_clusters=self.n_clusters, nprobe=self.nprobe,
                  metric=self.metric, train_min=self.train_min,
                  reserved_space=self.reserved_space)

        def factory():
            return IvfKnn(dim, **kw)

        return DataIndex(data_table, data_column, index_factory=factory,
                         metadata_column=metadata_column,
                         embedder=self.embedder)


@dataclasses.dataclass
class LshKnnFactory(AbstractRetrieverFactory):
    dimensions: int | None = None
    n_or: int = 8
    n_and: int = 6
    embedder: Callable | None = None
    metric: str = "cos"

    def _inner(self) -> Callable[[], LshKnn]:
        dim, n_or, n_and, metric = (self.dimensions, self.n_or, self.n_and,
                                    self.metric)
        return lambda: LshKnn(dim, n_or=n_or, n_and=n_and, metric=metric)

    def build_index(self, data_column, data_table, metadata_column=None
                    ) -> DataIndex:
        return DataIndex(data_table, data_column, index_factory=self._inner(),
                         metadata_column=metadata_column,
                         embedder=self.embedder)


@dataclasses.dataclass
class TantivyBM25Factory(AbstractRetrieverFactory):
    ram_budget: int = 50_000_000
    in_memory_index: bool = True

    def build_index(self, data_column, data_table, metadata_column=None
                    ) -> DataIndex:
        return DataIndex(data_table, data_column, index_factory=TantivyBM25,
                         metadata_column=metadata_column)


@dataclasses.dataclass
class HybridIndexFactory(AbstractRetrieverFactory):
    """RRF fusion over sub-retrievers (brute-force KNN, LSH and BM25
    factories).
    ``weights`` (one per sub-factory) scales each sub-index's RRF
    contribution; a zero weight disables that retriever end to end: its
    query-side embedding is not computed and no probe runs."""

    retriever_factories: list[AbstractRetrieverFactory] = dataclasses.field(
        default_factory=list)
    k: float = 60.0
    weights: list[float] | None = None

    def build_index(self, data_column, data_table, metadata_column=None
                    ) -> DataIndex:
        subs = self.retriever_factories
        k, weights = self.k, self.weights
        if weights is not None and len(weights) != len(subs):
            raise ValueError(
                f"weights must match retriever_factories length "
                f"({len(weights)} != {len(subs)})")
        sub_embedders = [getattr(f, "embedder", None) for f in subs]
        if weights is not None:
            sub_embedders = [None if w == 0.0 else emb
                             for emb, w in zip(sub_embedders, weights)]

        def make_inner(f):
            if isinstance(f, (BruteForceKnnFactory, LshKnnFactory)):
                return f._inner()
            if isinstance(f, TantivyBM25Factory):
                return TantivyBM25
            raise ValueError(f"unsupported sub-factory {f}")

        inner_factories = [make_inner(f) for f in subs]

        def factory():
            return HybridIndex([mk() for mk in inner_factories], k=k,
                               weights=weights)

        def hybrid_embedder(col):
            if isinstance(col, MakeTupleExpression):
                # the caller already provides one item per sub-index
                if len(col._args) != len(subs):
                    raise ValueError(
                        f"hybrid index expects {len(subs)} items per row, "
                        f"got a {len(col._args)}-tuple")
                return col
            # one raw column fanned out to one item per sub-index
            return MakeTupleExpression(*[
                emb(col) if emb is not None else col for emb in sub_embedders])

        return DataIndex(data_table, data_column, index_factory=factory,
                         metadata_column=metadata_column,
                         embedder=hybrid_embedder)
