"""Connectors (the port of ``pathway_tpu/io``): ``subscribe``, ``fs``
(binary, plaintext, csv and json files, static or streaming), ``csv``
and ``jsonlines`` (read and write), ``python`` (custom subjects),
``http`` (the serving half and the client connectors), the streaming
sources and sinks (``kafka`` with json, bson, avro through the schema
registry, plaintext, raw and debezium messages; ``nats``, ``mqtt`` and
``rabbitmq`` over their wire protocols; ``kinesis`` over SigV4-signed
calls; ``pubsub`` over an injected publisher), ``s3`` (and its aliases
``s3_csv`` and ``minio``), ``sqlite``, the aliases ``plaintext``,
``redpanda``, ``debezium``, ``null`` and ``logstash``, and input
synchronization groups.  Under ``pw.persistence`` the file, Kafka,
Kinesis and S3 sources journal their rows with their offsets.  The
databases: ``postgres``, ``mysql`` and ``mssql`` over an injected or
installed DB-API driver, ``mongodb`` and ``elasticsearch`` over their
clients, ``clickhouse`` and ``questdb`` over HTTP and ILP, ``dynamodb``
over SigV4-signed calls and ``bigquery`` over ``insertAll``.  The vector
stores: ``pinecone``, ``qdrant``, ``chroma``, ``milvus`` and
``weaviate`` over their REST APIs, and ``leann``'s index.  The lakes and
files: ``deltalake`` and ``iceberg`` (their table formats, natively, over
parquet), ``duckdb`` over an installed or injected connection and
``pyfilesystem`` over a duck-typed filesystem.  The documents and apps:
``gdrive`` and ``sharepoint`` over their clients, ``airbyte`` over a
connector command speaking the Airbyte protocol, and ``slack``'s alerts.
"""

from __future__ import annotations

import sys
import types

from . import (
    airbyte, bigquery, clickhouse, csv, deltalake, duckdb, dynamodb,
    elasticsearch, fs, gdrive, http, iceberg, jsonlines, kafka, kinesis,
    leann, milvus, mongodb, mqtt, mssql, mysql, nats, postgres, pubsub,
    pyfilesystem, python, questdb, rabbitmq, s3, sharepoint, slack, sqlite,
    vector_writers, weaviate,
)
from ._schema_registry import SchemaRegistryHeader, SchemaRegistrySettings
from ._subscribe import subscribe
from ._synchronization import register_input_synchronization_group
from .csv import CsvParserSettings


def _alias(name: str, **attrs) -> types.ModuleType:
    """A module ``pathway_tpu_torch.io.<name>`` holding ``attrs``."""
    mod = types.ModuleType(f"{__name__}.{name}")
    for k, v in attrs.items():
        setattr(mod, k, v)
    sys.modules[mod.__name__] = mod
    return mod


def _plaintext_read(path: str, *, mode: str = "streaming", **kwargs):
    return fs.read(path, format="plaintext", mode=mode, **kwargs)


plaintext = _alias("plaintext", read=_plaintext_read)
s3_csv = _alias("s3_csv",
                read=lambda path, **kw: s3.read(path, format="csv", **kw),
                write=s3.write)


class MinIOSettings(s3.AwsS3Settings):
    """Reference parity: pw.io.minio.MinIOSettings (endpoint-based S3)."""

    def __init__(self, endpoint=None, bucket_name=None, access_key=None,
                 secret_access_key=None, *, with_path_style=True, **kw):
        ep = endpoint
        if ep and not str(ep).startswith(("http://", "https://")):
            ep = f"https://{ep}"
        super().__init__(
            bucket_name=bucket_name, access_key=access_key,
            secret_access_key=secret_access_key, endpoint=ep,
            with_path_style=with_path_style, **kw,
        )


minio = _alias(
    "minio", MinIOSettings=MinIOSettings,
    read=lambda path, *, minio_settings=None, **kw: s3.read(
        path, aws_s3_settings=minio_settings, **kw),
    write=lambda table, path, *, minio_settings=None, **kw: s3.write(
        table, path, aws_s3_settings=minio_settings, **kw))
redpanda = kafka
# the vector-store sinks as pw.io.<name>.write
pinecone = _alias("pinecone", write=vector_writers.write_pinecone)
qdrant = _alias("qdrant", write=vector_writers.write_qdrant)
chroma = _alias("chroma", write=vector_writers.write_chroma)


def _debezium_read(rdkafka_settings, topic_name=None, *, schema=None, **kw):
    kw.pop("format", None)
    return kafka.read(rdkafka_settings, topic_name, schema=schema,
                      format="debezium", **kw)


debezium = _alias("debezium", read=_debezium_read)
null = _alias("null", write=lambda table, **kwargs: None)
# logstash's HTTP input plugin takes plain JSON POSTs
logstash = _alias("logstash",
                  write=lambda table, endpoint, **kw: http.write(
                      table, endpoint, **kw))

# the JAX package's list, in its order
__all__ = [
    "csv", "fs", "jsonlines", "kafka", "python", "http", "plaintext",
    "subscribe", "register_input_synchronization_group", "s3", "minio",
    "gdrive", "postgres", "mysql", "mongodb", "elasticsearch", "deltalake",
    "iceberg", "nats", "mqtt", "rabbitmq", "kinesis", "dynamodb", "bigquery",
    "redpanda", "airbyte", "debezium", "null", "sharepoint",
    "clickhouse", "questdb", "pinecone", "qdrant", "chroma",
    "weaviate", "milvus", "leann", "slack", "pubsub", "duckdb", "mssql",
    "pyfilesystem", "sqlite", "logstash",
]
