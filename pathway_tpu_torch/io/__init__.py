"""Connectors (the port of ``pathway_tpu/io``): ``subscribe``, ``fs``
(binary, plaintext, csv and json files, static or streaming), ``csv``
and ``jsonlines`` (read and write), ``python`` (custom subjects) and
``http``: the serving half (``rest_connector`` and ``PathwayWebserver``)
and the client connectors (``read`` and ``write``).  The message-queue,
database and cloud connectors, persistence and input synchronization
groups are not ported."""

from . import csv, fs, http, jsonlines, python
from ._subscribe import subscribe
from .csv import CsvParserSettings


def register_input_synchronization_group(*columns, max_difference,
                                         name: str = "default") -> None:
    """Input synchronization groups are not ported: raises."""
    raise NotImplementedError(
        "input synchronization groups are not supported by this package")


__all__ = ["CsvParserSettings", "csv", "fs", "http", "jsonlines", "python",
           "subscribe", "register_input_synchronization_group"]
