"""pathway_tpu_torch ``models/hf_import.py`` against the JAX package's.

The converters take a synthetic numpy state dict (BERT with and without
its ``bert.`` prefix, GPT-2 with and without ``transformer.``) and must
give the JAX converters' parameters exactly (bound 0: they transpose,
slice and add the same f32 arrays).  The config mappers must give the
same fields.  ``load_hf_*`` read a small randomly initialised model
saved with ``transformers`` into a temporary directory (no network);
``TorchEncoder.from_hf`` then embeds as ``JaxEncoder.from_hf`` does
(f32, ``atol=rtol=1e-4``).
"""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from pathway_tpu.models import encoder as jenc
from pathway_tpu.models import hf_import as jhf
from pathway_tpu_torch.models import encoder as tenc
from pathway_tpu_torch.models import hf_import as thf

D, F, V, L, P = 16, 40, 50, 2, 24


def _bert_state(seed, prefix=""):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    s = {"embeddings.word_embeddings.weight": a(V, D),
         "embeddings.position_embeddings.weight": a(P, D),
         "embeddings.token_type_embeddings.weight": a(2, D),
         "embeddings.LayerNorm.weight": a(D),
         "embeddings.LayerNorm.bias": a(D)}
    for i in range(L):
        p = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense"):
            s[p + name + ".weight"], s[p + name + ".bias"] = a(D, D), a(D)
        s[p + "intermediate.dense.weight"] = a(F, D)
        s[p + "intermediate.dense.bias"] = a(F)
        s[p + "output.dense.weight"] = a(D, F)
        s[p + "output.dense.bias"] = a(D)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            s[p + ln + ".weight"], s[p + ln + ".bias"] = a(D), a(D)
    return {prefix + k: v for k, v in s.items()}


def _gpt2_state(seed, prefix=""):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    s = {"wte.weight": a(V, D), "wpe.weight": a(P, D),
         "ln_f.weight": a(D), "ln_f.bias": a(D)}
    for i in range(L):
        p = f"h.{i}."
        s[p + "attn.c_attn.weight"], s[p + "attn.c_attn.bias"] = (
            a(D, 3 * D), a(3 * D))
        s[p + "attn.c_proj.weight"], s[p + "attn.c_proj.bias"] = a(D, D), a(D)
        s[p + "mlp.c_fc.weight"], s[p + "mlp.c_fc.bias"] = a(D, F), a(F)
        s[p + "mlp.c_proj.weight"], s[p + "mlp.c_proj.bias"] = a(F, D), a(D)
        for ln in ("ln_1", "ln_2"):
            s[p + ln + ".weight"], s[p + ln + ".bias"] = a(D), a(D)
    return {prefix + k: v for k, v in s.items()}


def _bert_cfg(**kw):
    return SimpleNamespace(**{**dict(
        model_type="bert", vocab_size=V, hidden_size=D, num_hidden_layers=L,
        num_attention_heads=2, intermediate_size=F,
        max_position_embeddings=P, hidden_act="gelu",
        layer_norm_eps=1e-12, position_embedding_type="absolute"), **kw})


def _gpt2_cfg(**kw):
    return SimpleNamespace(**{**dict(
        model_type="gpt2", vocab_size=V, n_embd=D, n_layer=L, n_head=2,
        n_inner=None, n_positions=P, layer_norm_epsilon=1e-5,
        activation_function="gelu_new"), **kw})


def _assert_same_tree(got, want):
    flat_w, tree_w = jax.tree_util.tree_flatten(want)
    flat_g, tree_g = jax.tree_util.tree_flatten(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert tree_g == tree_w
    for g, w in zip(flat_g, flat_w):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out.pop("dtype")
    return out


@pytest.mark.parametrize("prefix", ["", "bert."])
def test_bert_state_dict_converts_as_jax_does(prefix):
    state = _bert_state(0, prefix)
    cfg_j, cfg_t = jhf.config_from_hf(_bert_cfg()), thf.config_from_hf(
        _bert_cfg())
    assert _fields(cfg_t) == _fields(cfg_j)
    assert cfg_t.dtype == torch.float32
    _assert_same_tree(thf.params_from_bert_state_dict(state, cfg_t),
                      jhf.params_from_bert_state_dict(state, cfg_j))
    # torch tensors in the state dict (what transformers hands over)
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    _assert_same_tree(thf.params_from_bert_state_dict(tstate, cfg_t),
                      jhf.params_from_bert_state_dict(state, cfg_j))


@pytest.mark.parametrize("prefix", ["", "transformer."])
def test_gpt2_state_dict_converts_as_jax_does(prefix):
    state = _gpt2_state(1, prefix)
    cfg_j, cfg_t = jhf.config_from_gpt2(_gpt2_cfg()), thf.config_from_gpt2(
        _gpt2_cfg())
    assert _fields(cfg_t) == _fields(cfg_j)
    assert cfg_t.d_ff == 4 * D
    _assert_same_tree(thf.params_from_gpt2_state_dict(state, cfg_t),
                      jhf.params_from_gpt2_state_dict(state, cfg_j))


@pytest.mark.parametrize("bad,match", [
    (lambda: thf.config_from_hf(_gpt2_cfg()), "BERT-family"),
    (lambda: thf.config_from_hf(_bert_cfg(hidden_act="swish")),
     "unsupported hidden_act"),
    (lambda: thf.config_from_hf(
        _bert_cfg(position_embedding_type="relative_key")),
     "position_embedding_type"),
    (lambda: thf.config_from_gpt2(_bert_cfg()), "GPT-2-family"),
    (lambda: thf.config_from_gpt2(_gpt2_cfg(activation_function="swish")),
     "unsupported activation_function"),
    (lambda: thf.params_from_bert_state_dict({}, thf.config_from_hf(
        _bert_cfg())), "word_embeddings"),
])
def test_unsupported_configs_and_missing_weights_raise(bad, match):
    with pytest.raises((ValueError, KeyError), match=match):
        bad()


@pytest.fixture(scope="module")
def saved_models(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    bert_dir = tmp_path_factory.mktemp("bert")
    transformers.BertModel(transformers.BertConfig(
        vocab_size=V, hidden_size=D, num_hidden_layers=L,
        num_attention_heads=2, intermediate_size=F,
        max_position_embeddings=P, hidden_act="gelu",
    )).save_pretrained(bert_dir)
    gpt2_dir = tmp_path_factory.mktemp("gpt2")
    transformers.GPT2Model(transformers.GPT2Config(
        vocab_size=V, n_embd=D, n_layer=L, n_head=2, n_positions=P,
    )).save_pretrained(gpt2_dir)
    return str(bert_dir), str(gpt2_dir)


def test_load_hf_from_a_local_directory(saved_models):
    bert_dir, gpt2_dir = saved_models
    p_t, cfg_t, tok_t = thf.load_hf_encoder(bert_dir)
    p_j, cfg_j, _tok_j = jhf.load_hf_encoder(bert_dir)
    assert tok_t is None  # no tokenizer files saved beside the weights
    assert _fields(cfg_t) == _fields(cfg_j)
    _assert_same_tree(p_t, p_j)
    p_t, cfg_t, _tok = thf.load_hf_decoder(gpt2_dir)
    p_j, cfg_j, _tok = jhf.load_hf_decoder(gpt2_dir)
    assert _fields(cfg_t) == _fields(cfg_j)
    _assert_same_tree(p_t, p_j)


def test_encoder_from_hf_embeds_as_jax_does(saved_models):
    bert_dir, _ = saved_models
    kw = dict(seq_buckets=(8, 24), batch_buckets=(1, 4))
    t = tenc.TorchEncoder.from_hf(bert_dir, device="cpu", **kw)
    j = jenc.JaxEncoder.from_hf(bert_dir, **kw)
    assert t.cfg.ln_placement == "post" and t.cfg.dtype == torch.float32
    texts = ["a b c", "one two three four five six seven eight nine"]
    np.testing.assert_allclose(t.embed_batch(texts).numpy(),
                               j.embed_batch(texts), atol=1e-4, rtol=1e-4)


# -- TorchDecoderLM.from_hf and TorchChat(model=path) --------------------------


@pytest.fixture(scope="module")
def tiny_gpt2(tmp_path_factory):
    """A random tiny GPT-2 LM (the HF logits' oracle) and its transformer
    saved locally, as ``tests/test_hf_import.py`` saves one."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=150, n_embd=32, n_layer=2, n_head=4, n_positions=64,
    )).eval()
    path = tmp_path_factory.mktemp("tinygpt")
    model.transformer.save_pretrained(path)
    return model, str(path)


def test_decoder_from_hf_generates_the_jax_ids(tiny_gpt2):
    from pathway_tpu.models.decoder import JaxDecoderLM
    from pathway_tpu_torch.models.decoder import TorchDecoderLM

    _model, path = tiny_gpt2
    lm = TorchDecoderLM.from_hf(path, device="cpu")
    jlm = JaxDecoderLM.from_hf(path)
    assert lm.cfg.dtype == torch.float32 and lm.cfg.act == "gelu_tanh"
    assert lm.params["embed"].device.type == "cpu"
    for prompt, n in (("hello", 3), ("the quick brown fox jumps", 8)):
        got = lm.generate(prompt, max_new_tokens=n)
        assert got and got == jlm.generate(prompt, max_new_tokens=n)
    prompts = ["a b c", "one two three four five"]
    assert (lm.generate_batch(prompts, max_new_tokens=4)
            == jlm.generate_batch(prompts, max_new_tokens=4))


def test_decoder_from_hf_forward_logits_match_hf(tiny_gpt2):
    from pathway_tpu_torch.models.decoder import TorchDecoderLM, forward_logits

    model, path = tiny_gpt2
    lm = TorchDecoderLM.from_hf(path, device="cpu")
    ids = np.random.default_rng(0).integers(0, 150, (2, 10))
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(ids)).logits.numpy()
        ours = forward_logits(lm.params, lm.cfg, torch.tensor(ids)).numpy()
    assert np.abs(ours - ref).max() < 5e-4
    assert (ours[:, -1].argmax(-1) == ref[:, -1].argmax(-1)).all()


def test_chat_from_a_checkpoint_path_answers_as_jax_chat(tiny_gpt2):
    from pathway_tpu.xpacks.llm.llms import JaxChat
    from pathway_tpu_torch.xpacks.llm.llms import TorchChat

    _model, path = tiny_gpt2
    chat = TorchChat(model=path, max_new_tokens=5, device="cpu")
    jchat = JaxChat(model=path, max_new_tokens=5)
    assert chat.model_name == path
    question = [{"role": "user", "content": "what is a paged kv cache"}]
    assert chat(question) == jchat(question)
    assert (chat.generate_batch([question, "and a block table?"])
            == jchat.generate_batch([question, "and a block table?"]))
