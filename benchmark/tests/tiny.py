"""Tiny configurations and mixes of the benchmark's cells, for the CPU
tests: the cells' own files with their sizes cut."""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _load(kind, name):
    return json.loads((HERE / kind / f"{name}.json").read_text())


def gpt2():
    c = _load("configs", "gpt2-xl")
    c.update(n_embd=64, n_head=4, n_layer=2, vocab_size=512, n_positions=256,
             n_ctx=256, torch_dtype="float32")
    return c


def rag_mix():
    m = _load("traffic", "rag_answer")
    m.update(rate_per_s=20.0, ramp_s=0.3, callers=16, shared_prefix_tokens=16,
             prompt_tokens={"dist": "lognormal", "median": 60, "sigma": 0.25,
                            "min": 40, "max": 90},
             output_tokens={"dist": "uniform", "min": 4, "max": 12},
             max_total_tokens=128,
             engine={"max_batch_size": 4, "prefill_chunk": 32})
    m["check"] = {"requests": 6}
    return m


def decode_mix():
    m = _load("traffic", "long_decode")
    m.update(clients=4, supply_tokens_per_s=2000, shared_prefix_tokens=16,
             prompt_tokens={"dist": "uniform", "min": 40, "max": 60},
             output_tokens={"dist": "uniform", "min": 10, "max": 20},
             max_total_tokens=128,
             engine={"max_batch_size": 4, "prefill_chunk": 32})
    m["check"] = {"requests": 4}
    return m


def minilm():
    c = _load("configs", "minilm-l6-nq")
    c.update(hidden_size=64, num_attention_heads=4, num_hidden_layers=2,
             intermediate_size=128, vocab_size=1000, index_rows=20000,
             torch_dtype="float32")
    return c


def retrieve_mix():
    m = _load("traffic", "retrieve_nq")
    m.update(rate_per_s=40.0, ramp_s=0.2, callers=4, vocabulary_words=500)
    m["check"] = {"queries": 8}
    return m
