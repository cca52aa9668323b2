"""Tensor parallelism over a mesh of shards (``parallel/mesh.py``)."""

from .mesh import TPMesh, legal_tp_values, tp_mesh, validate_decoder_tp

__all__ = ["TPMesh", "legal_tp_values", "tp_mesh", "validate_decoder_tp"]
