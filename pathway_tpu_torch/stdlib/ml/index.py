"""KNNIndex: the classic ``stdlib/ml/index.py:9`` API (the port of
``pathway_tpu/stdlib/ml/index.py``), backed by ``DataIndex``.

``use_lsh=False`` builds a ``BruteForceKnnFactory`` index on ``device``
(default ``"cuda"``; without a card it raises unless ``device="cpu"``);
``use_lsh=True`` an ``LshKnnFactory`` one, host numpy, which takes no
device.
"""

from __future__ import annotations

from typing import Any

from ...internals.expression import ColumnExpression
from ...internals.table import Table
from ..indexing import BruteForceKnnFactory, DataIndex, LshKnnFactory


class KNNIndex:
    def __init__(
        self,
        data_embedding: ColumnExpression,
        data: Table,
        n_dimensions: int | None = None,
        n_or: int = 8,
        n_and: int = 6,
        bucket_length: float = 1.0,
        distance_type: str = "cosine",
        metadata: ColumnExpression | None = None,
        use_lsh: bool = False,
        *,
        device: Any = "cuda",
    ):
        metric = {"cosine": "cos", "euclidean": "l2sq", "dot": "dot"}.get(
            distance_type, "cos"
        )
        if use_lsh:
            factory = LshKnnFactory(dimensions=n_dimensions, n_or=n_or,
                                    n_and=n_and, metric=metric)
        else:
            factory = BruteForceKnnFactory(dimensions=n_dimensions,
                                           metric=metric, device=device)
        self.index: DataIndex = factory.build_index(
            data_embedding, data, metadata_column=metadata
        )
        self.data = data

    def get_nearest_items(self, query_embedding, k: int = 3,
                          collapse_rows: bool = True,
                          with_distances: bool = False,
                          metadata_filter=None) -> Table:
        reply = self.index.query(
            query_embedding, number_of_matches=k,
            metadata_filter=metadata_filter
        )
        if with_distances:
            return reply.with_columns(dist=reply._pw_index_reply_score)
        return reply

    def get_nearest_items_asof_now(self, query_embedding, k: int = 3,
                                   collapse_rows: bool = True,
                                   with_distances: bool = False,
                                   metadata_filter=None) -> Table:
        reply = self.index.query_as_of_now(
            query_embedding, number_of_matches=k,
            metadata_filter=metadata_filter
        )
        if with_distances:
            return reply.with_columns(dist=reply._pw_index_reply_score)
        return reply
