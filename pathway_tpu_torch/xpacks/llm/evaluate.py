"""Retrieval-quality evaluation: recall@k / NDCG@k / MRR over a labeled
query set (the BEIR-style gate); the port of
``pathway_tpu/xpacks/llm/evaluate.py``.

Reference: integration_tests/rag_evals/ tracks retrieval metrics + RAGAS in
MLFlow; python/pathway/xpacks/llm/embedders.py:77-802 is the embedding path
being validated.  This module is the in-tree equivalent: score a retriever
function against qrels and compare two retrieval stacks (e.g. the port's
encoder vs a torch reference re-creation of the same checkpoint) for
parity.  The corpora are built from what is installed (stdlib docstrings)
or generated from a seed, so nothing is downloaded.  ``pydoc_corpus``'s
extended module list leaves out the JAX stack's modules (``jax.*``,
``flax``, ``chex``, ``optax``): the port imports nothing of JAX.  A
module of the list that does not import (``ImportError``) is skipped;
any other error raised by importing it propagates.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Sequence


def recall_at_k(retrieved: Sequence, relevant: Iterable, k: int) -> float:
    rel = set(relevant)
    if not rel:
        return 0.0
    return len(set(retrieved[:k]) & rel) / len(rel)


def ndcg_at_k(retrieved: Sequence, relevant: Iterable, k: int) -> float:
    """Binary-relevance NDCG@k (the BEIR convention for datasets with
    unit gains)."""
    rel = set(relevant)
    if not rel:
        return 0.0
    dcg = sum(
        1.0 / math.log2(i + 2)
        for i, doc in enumerate(retrieved[:k])
        if doc in rel
    )
    ideal = sum(1.0 / math.log2(i + 2) for i in range(min(len(rel), k)))
    return dcg / ideal if ideal else 0.0


def mrr(retrieved: Sequence, relevant: Iterable) -> float:
    rel = set(relevant)
    for i, doc in enumerate(retrieved):
        if doc in rel:
            return 1.0 / (i + 1)
    return 0.0


def evaluate_retrieval(
    search: Callable[[str, int], Sequence],
    queries: Mapping[str, str],
    qrels: Mapping[str, Iterable],
    k: int = 10,
) -> dict:
    """Run `search(query_text, k) -> [doc_id, ...]` over every query and
    average recall@k / NDCG@k / MRR against the relevance labels."""
    n = 0
    tot_r = tot_n = tot_m = 0.0
    for qid, text in queries.items():
        relevant = qrels.get(qid, ())
        got = list(search(text, k))
        tot_r += recall_at_k(got, relevant, k)
        tot_n += ndcg_at_k(got, relevant, k)
        tot_m += mrr(got, relevant)
        n += 1
    if n == 0:
        return {"recall": 0.0, "ndcg": 0.0, "mrr": 0.0, "k": k, "queries": 0}
    return {
        "recall": round(tot_r / n, 4),
        "ndcg": round(tot_n / n, 4),
        "mrr": round(tot_m / n, 4),
        "k": k,
        "queries": n,
    }


def torch_reference_embedder(model, tokenizer, max_len: int = 64):
    """The reference's embedding path, shared by the bench and the parity
    test so both gate the SAME implementation: torch BERT forward + masked
    mean pooling + L2 norm (SentenceTransformer semantics,
    xpacks/llm/embedders.py:77-802)."""
    import torch

    def embed_many(texts):
        toks = [tokenizer.encode(t)[:max_len] for t in texts]
        T = max(len(t) for t in toks)
        ids = torch.zeros((len(toks), T), dtype=torch.long)
        mask = torch.zeros((len(toks), T), dtype=torch.long)
        for i, t in enumerate(toks):
            ids[i, : len(t)] = torch.tensor(t)
            mask[i, : len(t)] = 1
        with torch.no_grad():
            h = model(input_ids=ids, attention_mask=mask).last_hidden_state
        m = mask[:, :, None].float()
        pooled = (h * m).sum(1) / m.sum(1).clamp(min=1.0)
        return torch.nn.functional.normalize(pooled, dim=-1).numpy()

    return embed_many


_PYDOC_MODULES = (
    "os", "os.path", "json", "re", "logging", "asyncio", "email.message",
    "http.client", "urllib.request", "urllib.parse", "collections",
    "itertools", "socket", "ssl", "sqlite3", "datetime", "pathlib", "shutil",
    "subprocess", "threading", "multiprocessing", "argparse", "codecs",
    "csv", "difflib", "functools", "gzip", "hashlib", "heapq", "inspect",
    "io", "math", "pickle", "random", "statistics", "string", "tarfile",
    "tempfile", "textwrap", "typing", "warnings", "zipfile", "base64",
    "bisect", "calendar", "cmath", "configparser", "contextlib", "copy",
    "ctypes", "decimal", "enum", "fractions", "ipaddress", "locale",
    "mailbox", "mimetypes", "numbers", "operator", "platform", "pprint",
    "queue", "secrets", "selectors", "shelve", "shlex", "signal", "smtplib",
    "struct", "sysconfig", "time", "timeit", "tokenize", "trace",
    "traceback", "tracemalloc", "types", "unicodedata", "uuid", "weakref",
    "webbrowser", "xml.etree.ElementTree", "zlib", "socketserver",
    "wsgiref.util", "xmlrpc.client", "doctest", "unittest.mock", "pdb",
    "profile", "pstats", "dis", "ast", "symtable", "keyword", "linecache",
    "filecmp", "fnmatch", "stat", "fileinput", "getopt", "cmd", "code",
    "codeop", "pydoc", "py_compile", "compileall", "zipapp", "runpy",
    "importlib.util", "importlib.machinery", "pkgutil", "modulefinder",
    "email.utils", "email.header", "email.parser", "email.generator",
    "html.parser", "http.server", "http.cookies", "ftplib", "poplib",
    "imaplib", "binascii", "quopri", "bz2", "lzma", "netrc", "plistlib",
    "gettext", "optparse", "rlcompleter",
)

# installed third-party libraries carry thousands more real, documented
# English docstrings — the corpus scales to 5k+ items without any network
_PYDOC_MODULES_EXTRA = (
    "numpy", "numpy.linalg", "numpy.fft", "numpy.random", "numpy.ma",
    "numpy.polynomial", "numpy.testing", "numpy.char", "numpy.lib",
    "torch.nn.functional", "torch.linalg", "torch.fft", "torch.special",
    "torch.optim", "torch.utils.data", "torch.distributions",
    "pandas", "pandas.api.types", "pandas.tseries.frequencies",
    "einops",
    "torch.nn", "torch", "transformers.modeling_utils",
    "transformers.tokenization_utils_base", "transformers.trainer_utils",
    "scipy", "scipy.signal", "scipy.stats", "scipy.optimize",
    "scipy.sparse", "scipy.linalg", "scipy.interpolate", "scipy.ndimage",
    "scipy.spatial", "scipy.integrate", "sklearn.linear_model",
    "sklearn.metrics", "sklearn.cluster", "sklearn.preprocessing",
    "sklearn.decomposition", "sklearn.ensemble",
)


def pydoc_corpus(min_title_words: int = 4, min_body_words: int = 15,
                 extended: bool = False):
    """Real-text retrieval corpus from CPython stdlib docstrings (the only
    sizeable body of real, labeled English text available in a zero-egress
    environment): each item is (qualified_name, title, body) where title is
    the docstring's summary line and body is the rest.  Title->body is a
    genuine asymmetric retrieval task — the query paraphrases, but does not
    repeat, most of the document.  Deterministic: fixed module list, sorted
    member walk, content-hash dedup.  ``extended=True`` also harvests the
    installed scientific stack (numpy/torch/pandas/scipy), scaling the
    corpus past 5k items (the JAX stack's modules left out)."""
    import importlib
    import inspect as _inspect

    modules = _PYDOC_MODULES + (_PYDOC_MODULES_EXTRA if extended else ())
    items: list[tuple[str, str, str]] = []
    seen: set = set()
    for m in modules:
        try:
            mod = importlib.import_module(m)
        except ImportError:
            continue  # not installed here
        objs = []
        for name, obj in sorted(vars(mod).items(), key=lambda kv: kv[0]):
            if _inspect.isfunction(obj) or _inspect.isclass(obj):
                objs.append((name, obj))
                if _inspect.isclass(obj):
                    for mn, mo in sorted(
                        vars(obj).items(), key=lambda kv: kv[0]
                    ):
                        if _inspect.isfunction(mo):
                            objs.append((f"{name}.{mn}", mo))
        for name, obj in objs:
            doc = _inspect.getdoc(obj)
            if not doc:
                continue
            parts = doc.split("\n\n", 1)
            title = parts[0].replace("\n", " ").strip()
            body = (
                parts[1].replace("\n", " ").strip() if len(parts) > 1 else ""
            )
            if (
                len(title.split()) < min_title_words
                or len(body.split()) < min_body_words
            ):
                continue
            key = (title, body)
            if key in seen:
                continue
            seen.add(key)
            items.append((f"{m}.{name}", title, body))
    return items


def pydoc_retrieval_split(n_eval_docs: int = 600, n_queries: int = 120,
                          n_train: int = 400, seed: int = 0,
                          extended: bool = False):
    """Split the pydoc corpus into a labeled eval set (corpus/queries/qrels,
    query = title, relevant doc = its own body) and a DISJOINT train set of
    (title, body) pairs for contrastive checkpoint training."""
    import random as _random

    items = pydoc_corpus(extended=extended)
    rng = _random.Random(seed)
    rng.shuffle(items)
    eval_items = items[:n_eval_docs]
    train_items = items[n_eval_docs : n_eval_docs + n_train]
    corpus = {f"d{i}": body for i, (_q, _t, body) in enumerate(eval_items)}
    q_idx = rng.sample(range(len(eval_items)), min(n_queries, len(eval_items)))
    queries = {f"q{j}": eval_items[i][1] for j, i in enumerate(q_idx)}
    qrels = {f"q{j}": [f"d{i}"] for j, i in enumerate(q_idx)}
    train_pairs = [(t, b) for (_q, t, b) in train_items]
    return corpus, queries, qrels, train_pairs


def train_contrastive_torch(model, tokenizer, pairs, steps: int = 80,
                            batch: int = 48, lr: float = 1e-4,
                            max_len: int = 32, temperature: float = 0.1,
                            seed: int = 7):
    """Brief in-batch-negative InfoNCE training of a torch BERT-family model
    on (title, body) pairs — the zero-egress substitute for downloading a
    pretrained MiniLM: the resulting checkpoint is deterministic, seeded,
    and NON-random, so the retrieval-quality gate scores a
    checkpoint whose embeddings carry learned signal.

    batch=48 measured (isolated A/B, 500 docs / 100 queries, everything
    else fixed): recall@10 0.22 -> 0.38 over batch=24 — InfoNCE quality
    tracks the in-batch negative count, and 47 negatives are the
    sweet spot here (96 regressed to 0.36 while doubling cost;
    max_len 64 matched 0.38 at 2x the cost of this setting)."""
    import torch

    rng = __import__("random").Random(seed)
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def enc_batch(texts):
        toks = [tokenizer.encode(t)[:max_len] or [0] for t in texts]
        T = max(len(t) for t in toks)
        ids = torch.zeros((len(toks), T), dtype=torch.long)
        mask = torch.zeros((len(toks), T), dtype=torch.long)
        for i, t in enumerate(toks):
            ids[i, : len(t)] = torch.tensor(t)
            mask[i, : len(t)] = 1
        h = model(input_ids=ids, attention_mask=mask).last_hidden_state
        m = mask[:, :, None].float()
        pooled = (h * m).sum(1) / m.sum(1).clamp(min=1.0)
        return torch.nn.functional.normalize(pooled, dim=-1)

    model.train()
    losses = []
    for _step in range(steps):
        chunk = [pairs[rng.randrange(len(pairs))] for _ in range(batch)]
        titles = enc_batch([t for t, _b in chunk])
        bodies = enc_batch([b for _t, b in chunk])
        sim = titles @ bodies.T / temperature
        labels = torch.arange(len(chunk))
        # symmetric InfoNCE (title->body and body->title): measured the
        # difference between a checkpoint that collapses below the random
        # baseline and one that nearly doubles its recall@10
        loss = (
            torch.nn.functional.cross_entropy(sim, labels)
            + torch.nn.functional.cross_entropy(sim.T, labels)
        ) / 2
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    model.eval()
    return {"steps": steps, "loss_first": round(losses[0], 3),
            "loss_last": round(losses[-1], 3)}


def synthetic_beir_corpus(n_topics: int = 40, docs_per_topic: int = 6,
                          n_queries_per_topic: int = 2, seed: int = 0):
    """A scifact-shaped labeled corpus built from topic vocabularies.

    Each topic owns exclusive vocabulary; documents mix topic words with
    shared noise words, queries sample topic words, and the relevant set of
    a query is its topic's documents.  Lexical topic overlap gives even an
    untrained mean-pooled encoder real signal, so the benchmark separates a
    working retrieval stack from a broken one — and, run through two
    implementations of the SAME checkpoint, any metric gap exposes a
    numerical divergence (the parity gate)."""
    import random

    rng = random.Random(seed)
    shared = [f"common{i}" for i in range(200)]
    corpus: dict[str, str] = {}
    queries: dict[str, str] = {}
    qrels: dict[str, list[str]] = {}
    for t in range(n_topics):
        topic_vocab = [f"topic{t}word{j}" for j in range(12)]
        doc_ids = []
        for d in range(docs_per_topic):
            words = [rng.choice(topic_vocab) for _ in range(20)] + [
                rng.choice(shared) for _ in range(20)
            ]
            rng.shuffle(words)
            did = f"d{t}_{d}"
            corpus[did] = " ".join(words)
            doc_ids.append(did)
        for q in range(n_queries_per_topic):
            qid = f"q{t}_{q}"
            queries[qid] = " ".join(
                [rng.choice(topic_vocab) for _ in range(6)]
                + [rng.choice(shared) for _ in range(2)]
            )
            qrels[qid] = list(doc_ids)
    return corpus, queries, qrels
