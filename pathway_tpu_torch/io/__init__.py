"""Connectors (the port of ``pathway_tpu/io``): ``subscribe``, ``fs``
(binary and plaintext files, static or streaming), ``python`` (custom
subjects) and the serving half of ``http`` (``rest_connector`` and
``PathwayWebserver``).  ``csv``, ``jsonlines``, the HTTP client
connectors, the message-queue connectors and input synchronization
groups are not ported."""

from . import fs, http, python
from ._subscribe import subscribe


def register_input_synchronization_group(*columns, max_difference,
                                         name: str = "default") -> None:
    """Input synchronization groups are not ported: raises."""
    raise NotImplementedError(
        "input synchronization groups are not supported by this package")


__all__ = ["fs", "http", "python", "subscribe",
           "register_input_synchronization_group"]
