"""Tensor parallelism over a mesh of shards (``parallel/mesh.py``), the
data plane's segment programs (``mapreduce.py``) and its several workers:
the shard routers (``sharded.py``), the process fabric (``comm.py``) and
``ClusterRunner`` (``cluster.py``)."""

from .mesh import TPMesh, legal_tp_values, tp_mesh, validate_decoder_tp

__all__ = ["TPMesh", "legal_tp_values", "tp_mesh", "validate_decoder_tp"]
