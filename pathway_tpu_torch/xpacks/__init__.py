"""The port's extension packs (``pathway_tpu_torch.xpacks.llm``)."""

from . import llm

__all__ = ["llm"]
