"""Dataset helpers (parity module; reference: stdlib/ml/datasets/)."""

from __future__ import annotations


def load_lsh_test_data():  # pragma: no cover - parity stub
    raise NotImplementedError("bundled datasets are not shipped; load from CSV")
