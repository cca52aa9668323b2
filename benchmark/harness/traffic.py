"""The one traffic generator: it reads a mix's parameters from its data
file and draws the requests of one run from ``--seed``.

Every seed gets the same work.  The sizes (prompt, output and query
lengths) and the inter-arrival gaps are drawn once, in order, from the
mix's own ``shape_seed``: a fixed trace of the mix.  The run's seed draws
the content (token ids, words) and the weights.  So two seeds differ in
content, never in the amount, order or timing of the work, and the spread
between runs is the system's.
"""

from __future__ import annotations

import math

import numpy as np

# -- distributions ---------------------------------------------------------------


def draw_lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` integer lengths of a ``{"dist": ..., "min": .., "max": ..}``
    spec: ``uniform`` (both ends included) or ``lognormal`` (``median``,
    ``sigma``), clipped to [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, size=n)
    if spec["dist"] == "lognormal":
        x = rng.lognormal(math.log(float(spec["median"])),
                          float(spec["sigma"]), size=n)
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def zipf_sampler(n_items: int, a: float, rng: np.random.Generator):
    """A sampler of ids in [0, n_items) whose ranks follow Zipf(``a``)
    over a finite support; which id holds which rank is a permutation
    drawn from ``rng``."""
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    p = ranks ** (-a)
    cdf = np.cumsum(p / p.sum())
    perm = rng.permutation(n_items)

    def sample(size) -> np.ndarray:
        u = rng.random(size)
        return perm[np.minimum(np.searchsorted(cdf, u), n_items - 1)]

    return sample


def arrival_gaps(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` inter-arrival gaps in seconds: Poisson arrivals at
    ``rate_per_s`` (exponential gaps)."""
    if spec["arrivals"] != "poisson":
        raise ValueError(f"unknown arrivals {spec['arrivals']!r}")
    return rng.exponential(1.0 / float(spec["rate_per_s"]), size=n)


# -- generation mixes (prompts of token ids) -------------------------------------


def generation_requests(mix: dict, vocab: int, seed: int, n: int) -> dict:
    """``n`` requests of a generation mix: each a prompt of token ids that
    starts with the mix's shared prefix, and an output length.  Returns
    ``{"prompts": [np.ndarray], "outputs": np.ndarray, "gaps":
    np.ndarray | None}`` (gaps for an open loop)."""
    shape = np.random.default_rng(int(mix["shape_seed"]))
    plen = draw_lengths(mix["prompt_tokens"], n, shape)
    olen = draw_lengths(mix["output_tokens"], n, shape)
    cap = int(mix["max_total_tokens"])
    olen = np.minimum(olen, cap - plen)
    gaps = arrival_gaps(mix, n, shape) if mix["loop"] == "open" else None
    rng = np.random.default_rng(int(seed) % (1 << 63))
    ids = zipf_sampler(vocab, float(mix["token_zipf_a"]), rng)
    n_shared = int(mix["shared_prefix_tokens"])
    prefix = ids(n_shared)
    prompts = []
    for p in plen:
        body = ids(int(p) - n_shared)
        prompts.append(np.concatenate([prefix, body]).astype(np.int64))
    return {"prompts": prompts, "outputs": olen.astype(np.int64),
            "gaps": gaps}


# -- query mixes (texts) ---------------------------------------------------------

_SYLLABLES = ("ka", "to", "ri", "me", "sa", "lo", "ne", "vu", "di", "pa",
              "zo", "fe", "gu", "hi", "ja", "bo", "xe", "wu", "cy", "qo")
_STARTS = ("who", "what", "when", "where", "which", "how", "why")


def word_list(n_words: int, rng: np.random.Generator) -> list[str]:
    """``n_words`` distinct made-up words of two to four syllables."""
    words: list[str] = []
    seen: set[str] = set()
    while len(words) < n_words:
        k = int(rng.integers(2, 5))
        w = "".join(_SYLLABLES[int(i)] for i in rng.integers(0, 20, size=k))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def query_texts(mix: dict, seed: int, n: int) -> dict:
    """``n`` question texts of a query mix: a question word, then
    Zipf-drawn words, then ``?``; ``query_words`` counts every word
    including the first.  Returns ``{"texts": [str], "gaps":
    np.ndarray}``."""
    shape = np.random.default_rng(int(mix["shape_seed"]))
    nw = draw_lengths(mix["query_words"], n, shape)
    gaps = arrival_gaps(mix, n, shape)
    rng = np.random.default_rng(int(seed) % (1 << 63))
    words = word_list(int(mix["vocabulary_words"]), rng)
    pick = zipf_sampler(len(words), float(mix["word_zipf_a"]), rng)
    texts = []
    for k in nw:
        start = _STARTS[int(rng.integers(0, len(_STARTS)))]
        body = " ".join(words[int(i)] for i in pick(int(k) - 1))
        texts.append(f"{start} {body}?")
    return {"texts": texts, "gaps": gaps}
