"""ML utilities (reference: stdlib/ml/utils.py)."""

from __future__ import annotations

import functools
import itertools

from ...internals import reducers as R
from ...internals.expression import ColumnReference
from ...internals.table import Table


def classifier_accuracy(predicted_labels: Table, exact_labels: Table) -> Table:
    """Per-match-value counts of predicted vs exact labels (reference:
    ml/utils.py:13 — rows grouped by whether predicted_label == label)."""
    predicted_labels.promise_universe_is_subset_of(exact_labels)
    comp = predicted_labels.select(
        predicted_label=predicted_labels.predicted_label,
        label=exact_labels.restrict(predicted_labels).label,
    )
    comp = comp.with_columns(match=comp.label == comp.predicted_label)
    return comp.groupby(comp.match).reduce(
        cnt=R.count(), value=comp.match,
    )


def _predict_asof_now(prediction_function, with_queries_universe: bool = False):
    """Wrap a query->result pipeline so answers are one-shot: queries pass
    through forget-immediately, predictions run, and forgetting-time
    updates are filtered out — results never revise as the model/index
    changes later (reference: ml/utils.py _predict_asof_now)."""

    @functools.wraps(prediction_function)
    def wrapper(*args, **kwargs):
        cols = {}
        counter = itertools.count()
        table = None
        for arg in itertools.chain(args, kwargs.values()):
            if isinstance(arg, ColumnReference):
                table = arg.table
                cols[f"_pw_{next(counter)}"] = arg
        assert table is not None, (
            "at least one argument to a _predict_asof_now-wrapped function "
            "must be a ColumnReference"
        )
        queries = table.select(**cols)._forget_immediately()
        counter = itertools.count()
        new_args = [
            queries[f"_pw_{next(counter)}"] if isinstance(a, ColumnReference)
            else a
            for a in args
        ]
        new_kwargs = {
            k: (queries[f"_pw_{next(counter)}"]
                if isinstance(v, ColumnReference) else v)
            for k, v in kwargs.items()
        }
        result = prediction_function(*new_args, **new_kwargs)
        result = result._filter_out_results_of_forgetting()
        if with_queries_universe:
            result = result.with_universe_of(table)
        return result

    return wrapper
