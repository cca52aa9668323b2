"""Connectors: ``pw.io.subscribe`` (the port of ``pathway_tpu/io``'s
subscribe).  The file, message-queue and HTTP connectors, and input
synchronization groups, are not ported."""

from ._subscribe import subscribe


def register_input_synchronization_group(*columns, max_difference,
                                         name: str = "default") -> None:
    """Input synchronization groups are not ported: raises."""
    raise NotImplementedError(
        "input synchronization groups are not supported by this package")


__all__ = ["subscribe", "register_input_synchronization_group"]
