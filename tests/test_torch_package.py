"""pathway_tpu_torch package rules.

- importing the package and every submodule loads neither ``jax`` nor
  ``pathway_tpu`` (checked in a fresh interpreter), and no source file
  of the port or ``chip_smoke.py`` imports them;
- entry points called without ``device=`` on a machine with no CUDA
  device raise instead of falling back to the CPU (the RAG pipeline's
  too: a document store with its default retriever, a KNN factory's
  index, a REST server's run, ``pw.run`` over a file source);
- ``chip_smoke.py`` exits non-zero and prints no result without a card.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import pathway_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = pathlib.Path(pathway_tpu_torch.__file__).parent


def _modules():
    names = set()
    for p in PORT.rglob("*.py"):
        parts = p.relative_to(PORT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.add(".".join(("pathway_tpu_torch",) + parts))
    return sorted(names)


def test_the_guard_covers_the_observatory():
    """The import guards below walk every module of the port, the
    observatory's included."""
    for name in ("obs", "obs.tracer", "obs.costdb", "obs.profiler",
                 "obs.memory", "obs.planner"):
        assert f"pathway_tpu_torch.{name}" in _modules()


def test_the_guard_covers_the_parallel_modules():
    """... and the tensor-parallel ones: the mesh, the sharded KNN and the
    sequence-parallel attention."""
    for name in ("parallel", "parallel.mesh", "ops.knn_sharded",
                 "models.attention"):
        assert f"pathway_tpu_torch.{name}" in _modules()


def test_the_guard_covers_the_model_and_embedder_modules():
    """... and the CLIP dual encoder, the result caches and the embedder
    with the JAX package's ``BaseEmbedder`` surface."""
    for name in ("models.clip", "internals.udfs", "xpacks.llm.embedders"):
        assert f"pathway_tpu_torch.{name}" in _modules()


def test_the_guard_covers_the_data_plane_modules():
    """... and the data plane: tables, expressions, the runner and its
    operators, the vectorized tier and the segment programs."""
    for name in ("internals.value", "internals.dtype", "internals.schema",
                 "internals.expression", "internals.expressions.string",
                 "internals.expressions.date_time",
                 "internals.expressions.numerical",
                 "internals.expressions.binary", "internals.thisclass",
                 "internals.desugaring", "internals.type_interpreter",
                 "internals.parse_graph", "internals.trace",
                 "internals.table", "internals.reducers",
                 "internals.datasource", "internals.run", "engine",
                 "engine.types", "engine.graph", "engine.columnar",
                 "engine.reducers_impl", "engine.operators",
                 "engine.telemetry", "engine.vectorize", "engine.runner",
                 "parallel.mapreduce", "debug", "io", "io._subscribe"):
        assert f"pathway_tpu_torch.{name}" in _modules()


def test_the_guard_covers_the_rag_pipeline_modules():
    """... and the RAG pipeline: the indexes behind ``DataIndex``, the
    as-of-now join, the connectors and the LLM xpack."""
    for name in ("stdlib.indexing", "stdlib.indexing.data_index",
                 "stdlib.indexing.inner_index", "stdlib.indexing.retrievers",
                 "stdlib.temporal", "stdlib.temporal._asof_now_join",
                 "io._utils", "io.python", "io.fs", "io.http", "xpacks.llm",
                 "xpacks.llm.parsers", "xpacks.llm.splitters",
                 "xpacks.llm.prompts", "xpacks.llm.document_store",
                 "xpacks.llm.question_answering", "xpacks.llm.servers"):
        assert f"pathway_tpu_torch.{name}" in _modules()


def test_the_guard_covers_the_temporal_stream_and_async_modules():
    """... and the temporal slice: windows, temporal joins, behaviors,
    sort, the time, stream and async operators, the UDF executors,
    iterate, gradual broadcast and the csv / jsonlines connectors."""
    for name in ("stdlib.temporal.temporal_behavior",
                 "stdlib.temporal._window", "stdlib.temporal._interval_join",
                 "stdlib.temporal._window_join", "stdlib.temporal._asof_join",
                 "stdlib.temporal._sort", "stdlib.temporal.time_utils",
                 "stdlib.ordered", "stdlib.statistical", "stdlib.stateful",
                 "stdlib.utils", "stdlib.utils.col",
                 "stdlib.utils.async_transformer", "engine.time_ops",
                 "engine.stream_ops", "engine.async_ops",
                 "engine.gradual_broadcast", "internals.iterate",
                 "internals.udfs", "io.csv", "io.jsonlines"):
        assert f"pathway_tpu_torch.{name}" in _modules()


def test_the_guard_covers_the_rag_remainder_modules():
    """... and the rest of the RAG xpack: the licence gates, the IVF / LSH
    tiers behind the classic ML API, the parsers' OCR engine, the
    rerankers, the vector store, MCP and retrieval evaluation."""
    for name in ("internals.config", "internals.licensing", "stdlib.ml",
                 "stdlib.ml.index", "stdlib.ml.classifiers",
                 "xpacks.llm._ocr", "xpacks.llm.rerankers",
                 "xpacks.llm.vector_store", "xpacks.llm.mcp_server",
                 "xpacks.llm.evaluate"):
        assert f"pathway_tpu_torch.{name}" in _modules()


def test_the_guard_covers_the_core_api_modules():
    """... and the core API's pure-Python remainder and the native hash
    tier."""
    for name in ("native", "internals.sql", "internals.universes",
                 "internals.compat", "internals.row_transformer",
                 "internals.yaml_loader", "internals.interactive",
                 "stdlib.graphs", "stdlib.ml.hmm", "stdlib.ml.smart_table_ops",
                 "stdlib.ml.utils", "stdlib.ml.datasets", "demo"):
        assert f"pathway_tpu_torch.{name}" in _modules()


def test_the_guard_covers_the_streaming_source_modules():
    """... and the streaming sources: the codecs, the registry client, the
    message-queue and cloud connectors, sqlite and synchronization."""
    for name in ("io._synchronization", "io._avro", "io._bson",
                 "io._schema_registry", "io.kafka", "io.nats", "io.mqtt",
                 "io.rabbitmq", "io._aws", "io.kinesis", "io.pubsub",
                 "io.s3", "io.sqlite"):
        assert f"pathway_tpu_torch.{name}" in _modules()


def test_the_guard_covers_the_cluster_and_monitoring_modules():
    """... and several workers and processes, monitoring, the engine's
    telemetry, the CLI and the web dashboard."""
    for name in ("parallel.sharded", "parallel.comm", "parallel.cluster",
                 "cli", "__main__", "internals.monitoring", "web_dashboard",
                 "web_dashboard.db", "web_dashboard.dashboard"):
        assert f"pathway_tpu_torch.{name}" in _modules()


# the JAX package's connectors this package does not port yet (ROADMAP
# queue A, item 3): lakes, databases, vector stores, documents and apps
QUEUED_CONNECTORS = [
    "gdrive", "postgres", "mysql", "mongodb", "elasticsearch", "deltalake",
    "iceberg", "dynamodb", "bigquery", "airbyte", "sharepoint",
    "clickhouse", "questdb", "pinecone", "qdrant", "chroma", "weaviate",
    "milvus", "leann", "slack", "duckdb", "mssql", "pyfilesystem",
]


def test_the_io_surface_is_the_jax_packages_less_the_queued_connectors():
    import pathway_tpu as jpw

    want = [n for n in jpw.io.__all__ if n not in QUEUED_CONNECTORS]
    assert pathway_tpu_torch.io.__all__ == want
    assert all(hasattr(pathway_tpu_torch.io, n) for n in want)
    assert not any(hasattr(pathway_tpu_torch.io, n)
                   for n in QUEUED_CONNECTORS)
    for name in ("SchemaRegistrySettings", "SchemaRegistryHeader",
                 "CsvParserSettings"):
        assert hasattr(pathway_tpu_torch.io, name)
    for alias in ("plaintext", "s3_csv", "minio", "debezium", "null",
                  "logstash"):
        mod = sys.modules[f"pathway_tpu_torch.io.{alias}"]
        assert getattr(pathway_tpu_torch.io, alias) is mod


def test_importing_io_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import pathway_tpu_torch.io as io\n"
        "assert io.kafka and io.s3 and io.register_input_synchronization_group\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'pathway_tpu' "
        "or m.startswith('pathway_tpu.'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_every_name_of_the_jax_packages_all_resolves():
    import pathway_tpu as jpw

    missing = [n for n in jpw.__all__ if not hasattr(pathway_tpu_torch, n)]
    assert missing == []
    assert all(hasattr(pathway_tpu_torch, n)
               for n in pathway_tpu_torch.__all__)


def test_import_initialises_no_cuda():
    code = (
        "import torch, pathway_tpu_torch as pw\n"
        "assert pw.Table and pw.debug and pw.io.subscribe and pw.run\n"
        "assert not torch.cuda.is_initialized()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'pathway_tpu' "
        "or m.startswith('pathway_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", [*sorted(PORT.rglob("*.py")),
                                  ROOT / "chip_smoke.py",
                                  ROOT / "chip_obs_ab.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "pathway_tpu"), (path, name)


def _entry_points():
    from pathway_tpu_torch.kvcache.block_pool import BlockPool
    from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine
    from pathway_tpu_torch.models import clip, decoder, encoder
    from pathway_tpu_torch.models.host_encoder import CompiledQueryEncoder
    from pathway_tpu_torch.models.tokenizer import HashTokenizer
    from pathway_tpu_torch.ops.device_store import DeviceVecStore
    from pathway_tpu_torch.ops.knn_cuda import knn_topk
    from pathway_tpu_torch.serve.fleet import ReplicaFleet
    from pathway_tpu_torch.stdlib.indexing.inner_index import BruteForceKnn
    from pathway_tpu_torch.xpacks.llm.embedders import (
        SentenceTransformerEmbedder)
    from pathway_tpu_torch.xpacks.llm.llms import TorchChat

    dcfg = decoder.DecoderConfig(vocab_size=32, d_model=8, n_layers=1,
                                 n_heads=2, d_ff=16, max_len=16)
    ecfg = encoder.EncoderConfig(vocab_size=32, d_model=8, n_layers=1,
                                 n_heads=2, d_ff=16, max_len=16)
    params = decoder.init_decoder_params(dcfg, 0, device="cpu")
    import numpy as np

    import pathway_tpu_torch as pw
    from pathway_tpu_torch.engine.runner import GraphRunner, run_tables
    from pathway_tpu_torch.internals import parse_graph as pg
    from pathway_tpu_torch.obs.planner import calibrate_mapreduce
    from pathway_tpu_torch.parallel import mapreduce

    def table():
        pg.G.clear()
        return pw.debug.table_from_markdown("a | b\n1 | 2")

    def run():
        pw.io.subscribe(table(), on_change=lambda **kw: None)
        pw.run()

    from pathway_tpu_torch.stdlib.indexing import (BruteForceKnnFactory,
                                                   TantivyBM25Factory)
    from pathway_tpu_torch.xpacks.llm.document_store import DocumentStore
    from pathway_tpu_torch.xpacks.llm.question_answering import (
        BaseRAGQuestionAnswerer)
    from pathway_tpu_torch.xpacks.llm.servers import QARestServer

    def docs():
        pg.G.clear()
        return pw.debug.table_from_markdown("data\n1 | a")

    def qa_server_run():
        store = DocumentStore(docs(), retriever_factory=TantivyBM25Factory())
        rag = BaseRAGQuestionAnswerer(lambda messages: "x", store)
        QARestServer("127.0.0.1", 0, rag).run(timeout_s=1.0)

    def fs_run():
        import tempfile

        pg.G.clear()
        pw.io.subscribe(pw.io.fs.read(tempfile.gettempdir() + "/no-such-dir",
                                      mode="streaming"),
                        on_change=lambda **kw: None)
        pw.run(timeout_s=1.0)

    def kafka_run():
        pg.G.clear()
        pw.io.subscribe(pw.io.kafka.read({"_consumer": object()}, "t",
                                         format="plaintext"),
                        on_change=lambda **kw: None)
        pw.run(timeout_s=1.0)

    from pathway_tpu_torch.stdlib.ml import KNNIndex
    from pathway_tpu_torch.xpacks.llm.rerankers import EncoderReranker
    from pathway_tpu_torch.xpacks.llm.vector_store import VectorStoreServer

    def live_snapshot():
        pw.enable_interactive_mode()
        return table().live().snapshot()

    codes = np.zeros(4, np.int32)
    return {
        "LiveTable.snapshot": live_snapshot,
        "table_to_parquet": lambda: pw.debug.table_to_parquet(
            table(), "/dev/null"),
        "VectorStoreServer": lambda: VectorStoreServer(docs()),
        "EncoderReranker": lambda: EncoderReranker(),
        "KNNIndex": lambda: KNNIndex(docs().data, docs()),
        "DocumentStore": lambda: DocumentStore(docs()),
        "BruteForceKnnFactory.build_index": lambda: BruteForceKnnFactory(
            dimensions=8).build_index(docs().data, docs()),
        "QARestServer.run": qa_server_run,
        "pw.run(io.fs.read)": fs_run,
        "pw.run(io.kafka.read)": kafka_run,
        "run_tables": lambda: run_tables(table()),
        "GraphRunner": lambda: GraphRunner([table()._materialize_capture()]),
        "pw.run": run,
        "compute_and_print": lambda: pw.debug.compute_and_print(table()),
        "table_to_pandas": lambda: pw.debug.table_to_pandas(table()),
        "segment_sum": lambda: mapreduce.segment_sum(codes, codes, 1),
        "hash_join_membership": lambda: mapreduce.hash_join_membership(
            codes, codes),
        "calibrate_mapreduce": lambda: calibrate_mapreduce(sizes=(1024,)),
        "TorchEncoder": lambda: encoder.TorchEncoder(ecfg),
        "init_params": lambda: encoder.init_params(ecfg),
        "TorchDecoderLM": lambda: decoder.TorchDecoderLM(dcfg),
        "TorchDecoderLM.generate": lambda: decoder.TorchDecoderLM(
            dcfg, params=params).generate("a b", 2),
        "PagedDecodeEngine": lambda: PagedDecodeEngine(dcfg, params),
        "BlockPool": lambda: BlockPool(num_blocks=4, block_size=4,
                                       n_layers=1, n_heads=2, head_dim=4),
        "BruteForceKnn": lambda: BruteForceKnn(8),
        "knn_topk": lambda: knn_topk(torch.zeros(4, 8), torch.zeros(1, 8), 2),
        "DeviceVecStore": lambda: DeviceVecStore(8),
        "CompiledQueryEncoder": lambda: CompiledQueryEncoder(
            ecfg, encoder.init_params(ecfg, device="cpu"), HashTokenizer(32)),
        "SentenceTransformerEmbedder": lambda: SentenceTransformerEmbedder(
            config=ecfg),
        "ReplicaFleet": lambda: ReplicaFleet(dcfg, params, replicas=2),
        "TorchChat": lambda: TorchChat(dcfg, params=params),
        "TorchClip": lambda: clip.TorchClip(),
        "make_train_step": lambda: decoder.make_train_step(dcfg),
    }


@pytest.mark.parametrize("name", [
    "BlockPool", "BruteForceKnn", "CompiledQueryEncoder", "DeviceVecStore",
    "PagedDecodeEngine", "ReplicaFleet", "SentenceTransformerEmbedder",
    "TorchChat", "TorchClip", "TorchDecoderLM", "TorchDecoderLM.generate",
    "TorchEncoder", "init_params", "knn_topk", "make_train_step",
    "run_tables", "GraphRunner", "pw.run", "compute_and_print",
    "table_to_pandas", "segment_sum", "hash_join_membership",
    "calibrate_mapreduce", "DocumentStore", "BruteForceKnnFactory.build_index",
    "QARestServer.run", "pw.run(io.fs.read)", "pw.run(io.kafka.read)",
    "VectorStoreServer",
    "EncoderReranker", "KNNIndex", "LiveTable.snapshot", "table_to_parquet",
])
def test_entry_point_without_a_card_raises(name, monkeypatch):
    # decided inside the test: the default device is the card, and a
    # machine without one raises rather than computing on the CPU
    from pathway_tpu_torch.internals import parse_graph as pg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _entry_points()[name]()
    finally:
        pg.G.clear()  # the data-plane cases leave their sinks


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    # no visible card, both in the checkout and beside nothing of the repo
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                             cwd=cwd, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_chip_smoke_core_api_only_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--core-api-only"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "core_api" not in out.stdout


def test_chip_smoke_queues_only_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--queues-only"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "queues" not in out.stdout


def test_chip_smoke_cluster_only_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--cluster-only"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "cluster" not in out.stdout


@pytest.mark.parametrize("call", ["tp_mesh()", "tp_mesh(2)",
                                  "resolve_tp(cfg, 2)", "engine(tp=2)"])
def test_tensor_parallelism_without_a_card_raises(call, monkeypatch):
    """Shards default to CUDA devices: with none, asking for a mesh or
    for tp > 1 raises instead of placing shards on the CPU."""
    from pathway_tpu_torch.kvcache.engine import PagedDecodeEngine, resolve_tp
    from pathway_tpu_torch.models import decoder
    from pathway_tpu_torch.parallel.mesh import tp_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    cfg = decoder.DecoderConfig(vocab_size=32, d_model=8, n_layers=1,
                                n_heads=2, d_ff=16, max_len=16)
    calls = {
        "tp_mesh()": lambda: tp_mesh(),
        "tp_mesh(2)": lambda: tp_mesh(2),
        "resolve_tp(cfg, 2)": lambda: resolve_tp(cfg, 2),
        "engine(tp=2)": lambda: PagedDecodeEngine(
            cfg, decoder.init_decoder_params(cfg, 0, device="cpu"), tp=2),
    }
    with pytest.raises((ValueError, RuntimeError),
                       match="CUDA device|local devices|device='cpu'"):
        calls[call]()
