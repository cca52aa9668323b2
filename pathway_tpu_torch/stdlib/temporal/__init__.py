"""Temporal stdlib (the port of ``pathway_tpu/stdlib/temporal``): the
as-of-now join, which the document store's statistics and inputs
queries stand on.  Windows, sorting and the asof and interval joins are
not ported."""

from ._asof_now_join import (
    AsofNowJoinResult,
    asof_now_join,
    asof_now_join_inner,
    asof_now_join_left,
)

__all__ = ["AsofNowJoinResult", "asof_now_join", "asof_now_join_inner",
           "asof_now_join_left"]
