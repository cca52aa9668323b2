"""A BERT-family query encoder and an exact KNN index, the port's
retrieval path: ``CompiledQueryEncoder.embed_scheduled`` (CUDA graphs
behind a ``RequestScheduler``) -> ``BruteForceKnn.search`` over a
device-resident index.

The index holds the configuration's ``index_rows`` rows of standard normal
float32 vectors drawn from the seed, fed as the ingest path feeds them:
``DeviceVecStore.append_batch`` and one ``add`` a row.  The mix is an open
loop: Poisson arrivals, ``callers`` threads, each query embedded and then
searched for its top ``k``.

The check takes a sample of the window's answered queries, drawn from the
seed, and reads three numbers against the float32 reference:
``embed_dist``, the largest distance between the program's query vector
and the reference encoder's; ``rank_score_err``, the largest difference
between the program's score at each rank and the exact top-k score at
that rank (for the program's own query vector); and ``id_score_err``, the
largest difference between a returned score and the exact score of the
row its id names.  The control puts the reference in the program's place,
its encoder in per-tensor fp8 and its search in TF32.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time

import numpy as np
import torch

from ..harness import traffic, weights
from ..harness.load import open_window
from ..reference import bert as ref_bert
from ..reference import topk as ref_topk
from ..reference.precision import fp8_round


@dataclasses.dataclass
class Query:
    text: str
    due: float = math.nan
    sent: float = math.nan
    embedded: float = math.nan
    done: float = math.nan
    vec: np.ndarray | None = None
    ids: list | None = None
    scores: list | None = None
    error: str | None = None


def port_params(w: dict, cfg: dict) -> dict:
    """The benchmark's BERT tensors in the port's encoder layout: the
    segment-0 type row folded into the token table, as the port's BERT
    importer does."""
    e = "embeddings."
    layers = []
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        g = lambda n: w[p + n]  # noqa: E731
        layers.append({
            "wq": g("attention.self.query.weight"),
            "bq": g("attention.self.query.bias"),
            "wk": g("attention.self.key.weight"),
            "bk": g("attention.self.key.bias"),
            "wv": g("attention.self.value.weight"),
            "bv": g("attention.self.value.bias"),
            "wo": g("attention.output.dense.weight"),
            "bo": g("attention.output.dense.bias"),
            "w_up": g("intermediate.dense.weight"),
            "b_up": g("intermediate.dense.bias"),
            "w_down": g("output.dense.weight"),
            "b_down": g("output.dense.bias"),
            "ln1_scale": g("attention.output.LayerNorm.weight"),
            "ln1_bias": g("attention.output.LayerNorm.bias"),
            "ln2_scale": g("output.LayerNorm.weight"),
            "ln2_bias": g("output.LayerNorm.bias"),
        })
    D = cfg["hidden_size"]
    dev = w[e + "word_embeddings.weight"].device
    return {
        "embed": (w[e + "word_embeddings.weight"].float()
                  + w[e + "token_type_embeddings.weight"][0].float()),
        "pos_embed": w[e + "position_embeddings.weight"],
        "ln_e_scale": w[e + "LayerNorm.weight"],
        "ln_e_bias": w[e + "LayerNorm.bias"],
        "ln_f_scale": torch.ones(D, device=dev),
        "ln_f_bias": torch.zeros(D, device=dev),
        "layers": layers,
    }


def encoder_config(cfg: dict):
    """The port's ``EncoderConfig`` from the published BERT config, by the
    port's own converter."""
    import types

    from pathway_tpu_torch.models.hf_import import config_from_hf

    return config_from_hf(types.SimpleNamespace(**{
        k: v for k, v in cfg.items() if isinstance(v, (int, float, str))}))


class Cell:
    # the control is the reference, with no program
    control_runs_program = False

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 control: bool = False):
        self.cfg = config
        self.mix = mix
        self.seed = int(seed)
        self.device = torch.device(device)
        self.control = control
        self.encoder = self.index = None

    # -- set-up -----------------------------------------------------------------
    def setup(self) -> None:
        self.weights = weights.bert_weights(
            self.cfg, self.seed, self.device,
            getattr(torch, self.cfg["torch_dtype"]))
        if self.control:
            return  # the reference stands in the program's place
        from pathway_tpu_torch.models.host_encoder import CompiledQueryEncoder
        from pathway_tpu_torch.models.tokenizer import HashTokenizer
        from pathway_tpu_torch.ops.device_store import DeviceVecStore
        from pathway_tpu_torch.stdlib.indexing.inner_index import (
            BruteForceKnn)

        cfg = self.cfg
        self.encoder = CompiledQueryEncoder(
            encoder_config(cfg), port_params(self.weights, cfg),
            HashTokenizer(cfg["vocab_size"]), device=self.device)
        t0 = time.perf_counter()
        store = DeviceVecStore(cfg["hidden_size"], device=self.device)
        self.index = BruteForceKnn(cfg["hidden_size"], metric="cos",
                                   device=self.device)
        key = 0
        for block in weights.index_blocks(cfg["index_rows"],
                                          cfg["hidden_size"],
                                          self._index_seed(), self.device):
            for s in range(0, block.shape[0], store.BUF_ROWS):
                for h in store.append_batch(block[s:s + store.BUF_ROWS]):
                    self.index.add(key, h)
                    key += 1
            del block
        t1 = time.perf_counter()
        self._warm_up()
        print(f"[setup] index of {key} rows added in {t1 - t0:.3f} s; "
              f"warm-up {time.perf_counter() - t1:.3f} s", file=sys.stderr)

    def _index_seed(self) -> int:
        return self.seed + 1

    def _warm_up(self) -> None:
        """The first search consolidates the index; then the graphs of the
        query buckets this mix's lengths reach, and a few searches."""
        q = traffic.query_texts(self.mix, self.seed + 2, 64)["texts"]
        lens = {len(self.encoder.tokenizer.encode(t)) for t in q}
        lo, hi = self.mix["query_words"]["min"], self.mix["query_words"]["max"]
        for n in range(lo, hi + 2):  # words, and the question mark
            lens.add(n)
        for n in sorted(lens):
            self.encoder.warmup(" ".join(["warm"] * n))
        for t in q[:8]:
            self.index.search(self.encoder.embed_scheduled(t),
                              int(self.mix["k"]))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window -------------------------------------------------------------
    def _ask(self, q: Query) -> None:
        q.sent = time.perf_counter()
        try:
            vec = self.encoder.embed_scheduled(q.text)
            q.embedded = time.perf_counter()
            res = self.index.search(vec, int(self.mix["k"]))
            q.done = time.perf_counter()
            q.vec = np.asarray(vec, np.float32)
            q.ids = [int(i) for i, _s in res]
            q.scores = [float(s) for _i, s in res]
        except Exception as exc:  # noqa: BLE001 - a failed query is counted
            q.error = f"{type(exc).__name__}: {exc}"

    def run_window(self, seconds: float, on_open, on_close) -> dict:
        ramp = float(self.mix["ramp_s"])
        n = int(float(self.mix["rate_per_s"]) * (ramp + seconds) * 1.3) + 32
        gen = traffic.query_texts(self.mix, self.seed, n)
        qs = [Query(t) for t in gen["texts"]]
        t_open, t_close, ended = open_window(
            gen["gaps"], ramp, seconds, int(self.mix["callers"]),
            lambda i: self._ask(qs[i]), on_open, on_close, qs)
        return {"requests": qs, "t_open": t_open, "t_close": t_close,
                "ended": ended}

    def stop_program(self) -> None:
        if self.encoder is not None and self.encoder._serve_scheduler:
            self.encoder._serve_scheduler.shutdown(drain=False, timeout_s=30)
        self.encoder = self.index = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------------
    def sample_texts(self) -> list[str]:
        """The control's queries: the window's own mix, drawn from the seed."""
        n = int(self.mix["check"]["queries"])
        return traffic.query_texts(self.mix, self.seed, n)["texts"]

    def sample(self, result: dict) -> list[Query]:
        pool = [q for q in result["requests"]
                if result["t_open"] <= q.due < result["t_close"]
                and q.error is None and q.ids is not None]
        rng = np.random.default_rng(self.seed % (1 << 63) + 7)
        n = int(self.mix["check"]["queries"])
        return [pool[i] for i in sorted(rng.permutation(len(pool))[:n])]

    def control_answers(self) -> list[Query]:
        """The reference in the program's place: fp8 encoder, TF32 top-k."""
        k = int(self.mix["k"])
        qs = [Query(t) for t in self.sample_texts()]
        vecs = torch.stack([ref_bert.embed(self.weights, self.cfg, q.text,
                                           round_fn=fp8_round)
                            for q in qs])
        vals, ids = ref_topk.cosine_topk(vecs, self._blocks(), k,
                                         lower_precision=True)
        for j, q in enumerate(qs):
            q.vec = vecs[j].cpu().numpy()
            q.ids = ids[j].tolist()
            q.scores = vals[j].tolist()
        return qs

    def _blocks(self):
        return weights.index_blocks(self.cfg["index_rows"],
                                    self.cfg["hidden_size"],
                                    self._index_seed(), self.device)

    def check(self, result: dict | None) -> list[tuple[str, float, str]]:
        k = int(self.mix["k"])
        sample = (self.control_answers() if self.control
                  else self.sample(result))
        if not sample:
            return [(n, math.inf, "no query answered") for n in
                    ("embed_dist", "embed_dist_mean", "rank_score_err",
                     "id_score_err")]
        ref = torch.stack([ref_bert.embed(self.weights, self.cfg, q.text)
                           for q in sample])
        vec = torch.as_tensor(np.stack([q.vec for q in sample]),
                              device=self.device)
        dist = (vec - ref).norm(dim=1)
        exact_v, _ = ref_topk.cosine_topk(vec, self._blocks(), k)
        got_ids = torch.full((len(sample), k), -1, dtype=torch.long)
        got_v = torch.full((len(sample), k), math.nan)
        for j, q in enumerate(sample):
            got_ids[j, : len(q.ids)] = torch.as_tensor(q.ids)
            got_v[j, : len(q.scores)] = torch.as_tensor(q.scores)
        got_ids, got_v = got_ids.to(self.device), got_v.to(self.device)
        id_v = ref_topk.cosine_scores(vec, self._blocks(), got_ids)
        dupes = sum(len(set(q.ids)) != len(q.ids) for q in sample)
        rank_err = torch.nan_to_num((got_v - exact_v).abs(), nan=math.inf)
        id_err = torch.nan_to_num((got_v - id_v).abs(), nan=math.inf)
        id_score_err = math.inf if dupes else float(id_err.max())
        return [("embed_dist", float(dist.max()), f"{len(sample)} queries"),
                ("embed_dist_mean", float(dist.mean()),
                 f"{len(sample)} queries"),
                ("rank_score_err", float(rank_err.max()),
                 f"{len(sample)} queries x top {k}"),
                ("id_score_err", id_score_err,
                 f"{len(sample)} queries x top {k}, {dupes} with a repeated "
                 f"id")]
