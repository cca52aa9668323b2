"""The frozen arithmetic reproduces the kernel table's bounds at the main
path's shapes, and GPT-2 XL's published size."""

import json
from pathlib import Path

import pytest

from benchmark.harness import arith

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _ms(flops, nbytes, dtype):
    return arith.least_time_s(flops, nbytes, dtype) * 1e3


def test_ragged_kernel_bound():
    # #1: q (8, 32, 12, 64) bf16, sum of contexts 1701
    rows = [(32, 212)] * 7 + [(32, 217)]
    f, b = arith.ragged_kernel_work(rows, 12 * 64, 2)
    assert _ms(f, b, "bfloat16") == pytest.approx(0.0018, abs=5e-5)
    assert b / arith.PEAK_BYTES_PER_S > f / arith.PEAK_FLOPS["bfloat16"]


def test_append_kernel_bound():
    # #2: q (8, 1, 12, 64) bf16, sum of contexts 1638
    ctxs = [204] * 7 + [210]
    f = b = 0
    for c in ctxs:
        fi, bi = arith.decode_attention_work(c, 12 * 64, 1, 2)
        f, b = f + fi, b + bi
    assert _ms(f, b, "bfloat16") == pytest.approx(0.0015, abs=5e-5)


@pytest.mark.parametrize("q,ms", [(64, 0.0120), (1, 0.0075)])
def test_knn_scores_bound(q, ms):
    f, b = arith.knn_scores_work(q, 16384, 384)
    assert _ms(f, b, "float32") == pytest.approx(ms, abs=5e-5)


def test_gpt2_xl_parameters():
    c = json.loads((CONFIGS / "gpt2-xl.json").read_text())
    n = arith.gpt2_params(c["n_embd"], c["n_layer"],
                          c["n_inner"] or 4 * c["n_embd"], c["vocab_size"],
                          c["n_positions"])
    assert round(n / 1e9, 2) == 1.56


def test_prefill_and_decode_agree_with_ragged_rows():
    # a prompt of 40 positions past 8 cached ones, one layer, is one
    # ragged row of 40 queries over 48 keys; a decode token is a row of
    # one query (the ragged form leaves out its K/V write)
    D = 64
    assert arith.prefill_attention_work(8, 48, D, 1, 2) == \
        arith.ragged_kernel_work([(40, 48)], D, 2)
    f, b = arith.decode_attention_work(48, D, 1, 2)
    rf, rb = arith.ragged_kernel_work([(1, 48)], D, 2)
    assert (f, b - rb) == (rf, 2 * D * 2)


def test_prompt_flops_sum_of_positions():
    D, F, L, V = 32, 128, 2, 100
    whole = arith.prompt_flops(0, 10, D, F, L, V)
    by_pos = sum(arith.token_matmul_flops(D, F, L)
                 + arith.attention_flops(p + 1, D, L) for p in range(10))
    assert whole == by_pos + arith.head_flops(D, V)
