"""pw.universes — key-set promises (the port of ``pathway_tpu``'s; reference: python/pathway/internals/
universes.py + universe_solver.py)."""

from __future__ import annotations

from .table import Table, promise_universes_equal


def promise_are_pairwise_disjoint(*tables: Table) -> None:
    """Advisory promise that the tables' key sets never overlap.

    concat trusts the caller (as the reference trusts this promise); key
    collisions surface at sinks via squash() multiplicity checks, so the
    promise carries no runtime state here."""


def promise_are_equal(*tables: Table) -> None:
    """Assert the tables share a key set (enables same-universe column use)."""
    for t in tables[1:]:
        promise_universes_equal(tables[0], t)


def promise_is_subset_of(subset: Table, superset: Table) -> None:
    subset._universe.declare_subset_of(superset._universe)
