"""kNN LSH classifier (the port of ``pathway_tpu/stdlib/ml/classifiers.py``;
reference: stdlib/ml/classifiers/_knn_lsh.py).  Both of its indexes are
``LshKnn``, host numpy."""

from __future__ import annotations

from collections import Counter

from ...internals import dtype as dt
from ...internals.expression import ApplyExpression
from ...internals.table import Table
from .index import KNNIndex


def knn_lsh_classifier_train(data: Table, L: int = 8, type: str = "euclidean",  # noqa: A002
                             d: int | None = None, M: int = 6, A: float = 1.0):
    """Returns a classify(labels, queries) function (reference API)."""
    # one kwargs dict for both index builds: the labeled index uses the
    # metric and LSH configuration the classifier was trained with
    idx_kwargs = dict(
        n_dimensions=d, n_or=L, n_and=M,
        distance_type="cosine" if type == "cosine" else "euclidean",
        use_lsh=True,
    )
    index = KNNIndex(data.data, data, **idx_kwargs)

    def classify(labels: Table, queries: Table) -> Table:
        labeled = index.data.with_columns(
            _pw_label=labels.with_universe_of(index.data).label
        )
        idx2 = KNNIndex(labeled.data, labeled, **idx_kwargs)
        reply = idx2.get_nearest_items(queries.data, k=5)

        def vote(ls):
            ls = [l for l in ls if l is not None]  # noqa: E741
            if not ls:
                return None
            return Counter(ls).most_common(1)[0][0]

        return reply.select(
            predicted_label=ApplyExpression(vote, dt.ANY, (reply._pw_label,), {})
        )

    return classify


knn_lsh_train = knn_lsh_classifier_train
