"""At tiny sizes on the CPU, the plain references agree with the port
(which the references never import): the GPT-2 forward with the port's
dense decoder, the BERT encoder and the hash tokenizer with the port's,
and the exact top-k with a plain sort."""

import numpy as np
import pytest
import torch

from benchmark.systems import paged_engine, retrieval
from benchmark.harness import weights
from benchmark.reference import bert, gpt2, tokenizer, topk
from benchmark.tests import tiny


def test_gpt2_reference_matches_port_forward():
    from pathway_tpu_torch.models.decoder import forward_logits

    cfg = tiny.gpt2()
    w = weights.gpt2_weights(cfg, 5, "cpu", torch.float32)
    ids = torch.randint(0, cfg["vocab_size"], (2, 37),
                        generator=torch.Generator().manual_seed(1))
    port = forward_logits(paged_engine.port_params(w, cfg),
                          paged_engine.decoder_config(cfg, torch.float32), ids)
    pos = [torch.arange(37), torch.arange(37)]
    ref = gpt2.logits_at(w, cfg, [ids[0], ids[1]], pos)
    for j in range(2):
        torch.testing.assert_close(ref[j], port[j], rtol=1e-4, atol=1e-4)


def test_greedy_gaps_are_zero_for_reference_argmax():
    cfg = tiny.gpt2()
    w = weights.gpt2_weights(cfg, 6, "cpu", torch.float32)
    prompt = torch.arange(10, 30)
    seq, served = prompt.clone(), []
    for _ in range(5):  # greedy decoding by the reference itself
        lg = gpt2.logits_at(w, cfg, [seq], [torch.tensor([len(seq) - 1])])
        tok = int(lg[0][0].argmax())
        served.append(tok)
        seq = torch.cat([seq, torch.tensor([tok])])
    gaps = gpt2.greedy_gaps(w, cfg, [prompt], [served])[0]
    assert gaps.shape == (5,) and float(gaps.max()) == 0.0
    other = [(served[0] + 1) % cfg["vocab_size"]] + served[1:]
    assert float(gpt2.greedy_gaps(w, cfg, [prompt], [other])[0][0]) > 0


def test_tokenizer_matches_port():
    from pathway_tpu_torch.models.tokenizer import HashTokenizer

    text = "Who wrote THE Republic, and when? kato-rime 42"
    assert tokenizer.encode(text, 30522) == HashTokenizer(30522).encode(text)


def test_bert_reference_matches_port_encoder():
    from pathway_tpu_torch.models.encoder import encode
    from pathway_tpu_torch.models.tokenizer import HashTokenizer

    cfg = tiny.minilm()
    w = weights.bert_weights(cfg, 7, "cpu", torch.float32)
    text = "what sakato rime velo dipa?"
    ids = torch.tensor([HashTokenizer(cfg["vocab_size"]).encode(text)])
    ecfg = retrieval.encoder_config(cfg)
    port = encode(retrieval.port_params(w, cfg), ecfg, ids, None)[0]
    torch.testing.assert_close(bert.embed(w, cfg, text), port, rtol=1e-4,
                               atol=1e-5)


def test_exact_topk_matches_sort():
    g = torch.Generator().manual_seed(3)
    q = torch.randn(5, 16, generator=g)
    rows = torch.randn(1000, 16, generator=g)
    v, i = topk.cosine_topk(q, rows.split(300), 10)
    qn = q / q.norm(dim=1, keepdim=True)
    s = qn @ (rows / rows.norm(dim=1, keepdim=True)).T
    order = np.argsort(-s.numpy(), axis=1, kind="stable")[:, :10]
    assert (i.numpy() == order).all()
    torch.testing.assert_close(topk.cosine_scores(q, rows.split(300), i), v)


def test_index_blocks_repeat_from_the_seed():
    a = torch.cat(list(weights.index_blocks(1000, 8, 9, "cpu", 300)))
    b = torch.cat(list(weights.index_blocks(1000, 8, 9, "cpu", 300)))
    assert a.shape == (1000, 8) and torch.equal(a, b)


@pytest.mark.gpu
def test_gpt2_reference_matches_port_on_the_card(cuda_device):
    from pathway_tpu_torch.models.decoder import forward_logits

    cfg = tiny.gpt2()
    w = weights.gpt2_weights(cfg, 5, cuda_device, torch.float32)
    ids = torch.randint(0, cfg["vocab_size"], (1, 37), device=cuda_device)
    port = forward_logits(paged_engine.port_params(w, cfg),
                          paged_engine.decoder_config(cfg, torch.float32), ids)
    ref = gpt2.logits_at(w, cfg, [ids[0]], [torch.arange(37)])
    torch.testing.assert_close(ref[0], port[0], rtol=1e-3, atol=1e-3)
