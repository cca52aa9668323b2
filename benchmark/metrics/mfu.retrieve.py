"""The whole query's share of the card's peak: over the queries answered
in the window, the encoder's FLOPs at the bf16 peak plus the exact score
product's FLOPs (the index's valid float32 rows) at the float32 peak, over
the window."""

from benchmark.harness import arith
from benchmark.harness.stats import in_window
from benchmark.reference import tokenizer


def read(run):
    c = run.config
    D, F, L = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
    score_f, _b = arith.knn_scores_work(1, c["index_rows"], D)
    total = 0.0
    for q in run.result["requests"]:
        if q.error is not None or not in_window(run, q.done):
            continue
        n = max(1, len(tokenizer.encode(q.text, c["vocab_size"])))
        total += (arith.encoder_query_flops(n, D, F, L)
                  / arith.PEAK_FLOPS[c["torch_dtype"]]
                  + score_f / arith.PEAK_FLOPS[c["index_dtype"]])
    return 100.0 * total / run.seconds if total else None
