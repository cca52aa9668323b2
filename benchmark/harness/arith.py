"""The benchmark's frozen arithmetic: published peaks, and the operations
and bytes that a piece of work needs, computed from shapes alone.

Nothing here reads the program.  A metric that divides by a device time
takes its numerator from these functions, so it counts the same work
whatever implements it.  A "least time" is the larger of operations over
the peak rate and bytes over the memory bandwidth; each input byte is
counted as read once and each output byte as written once.
"""

from __future__ import annotations

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def least_time_s(flops: float, nbytes: float, dtype: str) -> float:
    """The roofline bound of ``flops`` operations and ``nbytes`` bytes."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


# -- transformer blocks --------------------------------------------------------


def block_matmul_params(d_model: int, d_ff: int) -> int:
    """Weights of one block's matrix products: Q, K, V, O and the MLP."""
    return 4 * d_model * d_model + 2 * d_model * d_ff


def block_params(d_model: int, d_ff: int) -> int:
    """All weights of one block: its products, their biases, two norms."""
    biases = 4 * d_model + d_ff + d_model
    norms = 4 * d_model
    return block_matmul_params(d_model, d_ff) + biases + norms


def gpt2_params(n_embd: int, n_layer: int, n_inner: int, vocab: int,
                n_positions: int) -> int:
    """GPT-2's parameters: tied token table, positions, blocks, final norm."""
    return (vocab * n_embd + n_positions * n_embd
            + n_layer * block_params(n_embd, n_inner) + 2 * n_embd)


def token_matmul_flops(d_model: int, d_ff: int, n_layers: int) -> int:
    """Operations of one token's matrix products through every block."""
    return 2 * n_layers * block_matmul_params(d_model, d_ff)


def attention_flops(ctx: int, d_model: int, n_layers: int) -> int:
    """Operations of one query token attending to ``ctx`` keys in every
    block: Q·K and P·V, two multiply-adds a key a channel each."""
    return 4 * ctx * d_model * n_layers


def head_flops(d_model: int, vocab: int) -> int:
    """Operations of one vocabulary head row."""
    return 2 * d_model * vocab


def prompt_flops(first: int, end: int, d_model: int, d_ff: int,
                 n_layers: int, vocab: int) -> int:
    """Model operations of computing prompt positions ``first .. end-1``
    (the positions below ``first`` are already cached), with one head row
    for the token that the last position emits."""
    n = end - first
    ctx_sum = (first + 1 + end) * n // 2   # sum of ctx = pos + 1
    return (n * token_matmul_flops(d_model, d_ff, n_layers)
            + attention_flops(ctx_sum, d_model, n_layers)
            + head_flops(d_model, vocab))


def decode_flops(ctx: int, d_model: int, d_ff: int, n_layers: int,
                 vocab: int) -> int:
    """Model operations of one generated token whose query attends to
    ``ctx`` positions (its own included)."""
    return (token_matmul_flops(d_model, d_ff, n_layers)
            + attention_flops(ctx, d_model, n_layers)
            + head_flops(d_model, vocab))


# -- attention kernels ---------------------------------------------------------


def prefill_attention_work(first: int, end: int, d_model: int, n_layers: int,
                           elt: int) -> tuple[int, int]:
    """(operations, bytes) of the causal attention of prompt positions
    ``first .. end-1`` over positions ``0 .. end-1``: the K and V of every
    position read once, each new query read and its output written once."""
    n = end - first
    ctx_sum = (first + 1 + end) * n // 2
    flops = attention_flops(ctx_sum, d_model, n_layers)
    nbytes = n_layers * elt * d_model * (2 * end + 2 * n)
    return flops, nbytes


def decode_attention_work(ctx: int, d_model: int, n_layers: int,
                          elt: int) -> tuple[int, int]:
    """(operations, bytes) of one decode token at context ``ctx``: the
    whole context's K and V read once, its own K and V written once, its
    query read and its output written once."""
    flops = attention_flops(ctx, d_model, n_layers)
    nbytes = n_layers * elt * d_model * (2 * ctx + 2 + 2)
    return flops, nbytes


def ragged_kernel_work(rows: list[tuple[int, int]], d_model: int,
                       elt: int) -> tuple[int, int]:
    """(operations, bytes) of one layer's ragged attention call over
    ``rows`` of (queries, context): each row's K and V read once, its
    queries read and outputs written once; query ``j`` of a row of ``c``
    keys and ``q`` queries sees ``c - q + j + 1`` keys."""
    flops = nbytes = 0
    for q, c in rows:
        ctx_sum = sum(c - q + j + 1 for j in range(q))
        flops += 4 * ctx_sum * d_model
        nbytes += elt * d_model * (2 * c + 2 * q)
    return flops, nbytes


# -- the KNN score product -----------------------------------------------------


def knn_scores_work(n_queries: int, n_rows: int, dim: int,
                    elt: int = 4) -> tuple[int, int]:
    """(operations, bytes) of ``n_queries`` queries scored against
    ``n_rows`` index rows: the rows and queries read once, the scores
    written once."""
    flops = 2 * n_queries * n_rows * dim
    nbytes = elt * (n_rows * dim + n_queries * dim + n_queries * n_rows)
    return flops, nbytes


def encoder_query_flops(n_tokens: int, d_model: int, d_ff: int,
                        n_layers: int) -> int:
    """Operations of one query of ``n_tokens`` tokens through a
    bidirectional encoder: every token's products and its attention over
    all the query's tokens."""
    return (n_tokens * token_matmul_flops(d_model, d_ff, n_layers)
            + n_tokens * attention_flops(n_tokens, d_model, n_layers))
