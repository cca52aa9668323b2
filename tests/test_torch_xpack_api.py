"""The LLM xpack's API-served and local-pipeline wrappers of the port
against the JAX package's, on the same stand-ins.

Each class gets the same inputs in both packages and must send the same
request (URL, payload, headers at a fixed ``amz_date``) through its
``_http`` seam, or make the same calls of a fake ``openai`` / ``litellm``
module put into ``sys.modules``, and return the same value.  Local
models (``HFPipelineChat``, ``HFTokenizer``) load a tiny random GPT-2 and
a word-level tokenizer saved into ``tmp_path``.  ``BaseChat`` on a
column expression: ``JaxChat`` and ``TorchChat`` on one set of converted
weights give the same output table.
"""

import datetime
import functools
import random
import sys
import types
import urllib.error
import uuid

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.io import _aws as jaws
from pathway_tpu.models import decoder as jdec
from pathway_tpu.models import tokenizer as jtok
from pathway_tpu.xpacks.llm import embedders as jemb
from pathway_tpu.xpacks.llm import llms as jllms
from pathway_tpu.xpacks.llm import parsers as jparsers
from pathway_tpu.xpacks.llm.llms import JaxChat
from pathway_tpu_torch.io import _aws as taws
from pathway_tpu_torch.models import decoder as tdec
from pathway_tpu_torch.models import tokenizer as ttok
from pathway_tpu_torch.models.convert import decoder_params_from_numpy
from pathway_tpu_torch.xpacks.llm import embedders as temb
from pathway_tpu_torch.xpacks.llm import llms as tllms
from pathway_tpu_torch.xpacks.llm import parsers as tparsers
from pathway_tpu_torch.xpacks.llm.llms import TorchChat

from .torch_parity import capture, fresh_port  # noqa: F401 - fixture

DEC = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
           max_len=128)
NEW = 6
QUESTIONS = """
        | prompt
      1 | "what is the mxu"
      2 | "which animal jumps"
      3 | "what holds the keys and values"
    """


@pytest.fixture(scope="module")
def chats():
    """``JaxChat`` held to its f32 fused tier (on the CPU its ``"auto"``
    tier is the int8 host decoder) and ``TorchChat`` on the same weights,
    converted by ``models/convert.py``."""
    cfg_j, cfg_t = jdec.DecoderConfig(**DEC), tdec.DecoderConfig(**DEC)
    pj = jdec.init_decoder_params(cfg_j, jax.random.PRNGKey(7))
    pt = decoder_params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                   cfg_t, device="cpu")
    jchat = JaxChat(cfg_j, params=pj, max_new_tokens=NEW)
    jchat._lm.generate = functools.partial(jchat._lm.generate, fused=True)
    return jchat, TorchChat(cfg_t, params=pt, max_new_tokens=NEW,
                            device="cpu")


def test_chat_on_a_column_expression_gives_the_jax_table(chats, fresh_port):
    jchat, tchat = chats

    def build(chat):
        def program(pw):
            t = pw.debug.table_from_markdown(QUESTIONS)
            return t.select(answer=chat(pw.this.prompt))
        return program

    want = capture("jax", build(jchat))
    got = capture("torch", build(tchat))
    assert got == want
    [answers] = got
    assert len(answers) == 3
    assert all(len(a.split()) == NEW for (a,) in answers.values())
    # each row's answer is the chat's answer to that question alone
    assert sorted(a for (a,) in answers.values()) == sorted(
        tchat([{"role": "user", "content": q}]) for q in (
            "what is the mxu", "which animal jumps",
            "what holds the keys and values"))


def test_chat_on_an_expression_keeps_a_none_row_none(chats, fresh_port):
    jchat, tchat = chats

    def build(chat):
        def program(pw):
            class S(pw.Schema):
                prompt: str | None

            t = pw.debug.table_from_rows(S, [("which animal jumps",),
                                             (None,)])
            return t.select(answer=chat(pw.this.prompt))
        return program

    [want] = capture("jax", build(jchat))
    [got] = capture("torch", build(tchat))
    assert got == want and (None,) in got.values()


# -- SigV4 REST signing and the Converse chat ----------------------------------


class _FixedNow(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 3, 4, 5, 6, 7, tzinfo=tz)


@pytest.fixture
def fixed_now(monkeypatch):
    """Both packages' ``_aws`` read this clock: the same ``x-amz-date``."""
    clock = types.SimpleNamespace(datetime=_FixedNow,
                                  timezone=datetime.timezone)
    for mod in (jaws, taws):
        monkeypatch.setattr(mod, "datetime", clock)


def _seeded_paths(n: int) -> list[str]:
    rng = random.Random(11)
    alphabet = "abcXYZ019-._~:%@+= /"
    paths = ["/model/anthropic.claude-3-haiku-20240307-v1:0/converse",
             "/model/a%3Ab/converse"]
    while len(paths) < n:
        seg = "".join(rng.choice(alphabet) for _ in range(rng.randint(3, 24)))
        paths.append(f"/model/{seg}/converse")
    return paths


@pytest.mark.parametrize("token", [None, "session-token"])
@pytest.mark.parametrize("path", _seeded_paths(8))
def test_sign_rest_request_equals_the_jax_signature(path, token):
    args = ("bedrock-runtime", "bedrock-runtime.us-east-1.amazonaws.com",
            path, b'{"messages": []}')
    want = jaws.sign_rest_request(jaws.AwsCredentials(
        "AK", "SK", "us-east-1", token), *args, amz_date="20260304T050607Z")
    got = taws.sign_rest_request(taws.AwsCredentials(
        "AK", "SK", "us-east-1", token), *args, amz_date="20260304T050607Z")
    assert got == want and want["authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AK/20260304/us-east-1/bedrock-runtime/")
    # the JSON-RPC signer beside it is unchanged
    assert taws.sign_request(
        taws.AwsCredentials("AK", "SK", "eu-west-1", token), "kinesis", "h",
        "Kinesis_20131202.PutRecords", b"{}", amz_date="20260304T050607Z"
    ) == jaws.sign_request(
        jaws.AwsCredentials("AK", "SK", "eu-west-1", token), "kinesis", "h",
        "Kinesis_20131202.PutRecords", b"{}", amz_date="20260304T050607Z")


def test_sign_rest_request_signs_the_double_encoded_path():
    creds = taws.AwsCredentials("AK", "SK", "us-east-1")
    path = "/model/anthropic.claude-3-haiku-20240307-v1:0/converse"
    one = taws.sign_rest_request(creds, "bedrock-runtime", "h", path, b"{}",
                                 amz_date="20260101T000000Z")
    two = taws.sign_rest_request(creds, "bedrock-runtime", "h",
                                 path.replace(":", "%3A"), b"{}",
                                 amz_date="20260101T000000Z")
    assert one["authorization"] != two["authorization"]
    # the double-encoded canonical path is what verifies
    assert chip_smoke.sigv4_valid(one, b"{}", "SK", "us-east-1",
                                  "bedrock-runtime",
                                  path.replace(":", "%253A"))
    assert not chip_smoke.sigv4_valid(one, b"{}", "SK", "us-east-1",
                                      "bedrock-runtime",
                                      path.replace(":", "%3A"))


def _recorder(answer):
    seen = []

    def http(*args):
        seen.append(args)
        return answer(*args)
    return seen, http


def _converse_reply(url, path, payload, headers):
    text = payload["messages"][-1]["content"][0]["text"]
    return {"output": {"message": {"content": [{"text": f"re: {text}"}]}}}


@pytest.mark.parametrize("env_creds", [False, True])
def test_bedrock_chat_sends_the_jax_request(fixed_now, monkeypatch,
                                            env_creds):
    if env_creds:
        for k, v in {"AWS_ACCESS_KEY_ID": "EK", "AWS_SECRET_ACCESS_KEY": "ES",
                     "AWS_SESSION_TOKEN": "ET", "AWS_REGION": "eu-central-1"
                     }.items():
            monkeypatch.setenv(k, v)
        kw = {}
    else:
        kw = dict(region="us-west-2", access_key="AK", secret_key="SK",
                  session_token="TOK")
    messages = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": "hello"},
                {"role": "assistant", "content": "hi"},
                {"role": "user", "content": "what is the mxu?"}]
    out = {}
    for name, mod in (("jax", jllms), ("torch", tllms)):
        seen, http = _recorder(_converse_reply)
        chat = mod.BedrockChat(temperature=0.2, topP=0.9, capacity=4,
                               _http=http, **kw)
        answers = [chat(messages), chat("a question", max_tokens=77,
                                        temperature=0.0, stopSequences=["x"])]
        out[name] = (answers, seen)
    assert out["torch"] == out["jax"]
    answers, seen = out["torch"]
    assert answers == ["re: what is the mxu?", "re: a question"]
    url, path, payload, headers = seen[1]
    assert url.endswith("/model/anthropic.claude-3-haiku-20240307-v1%3A0/"
                        "converse")
    assert payload["inferenceConfig"] == {"maxTokens": 77, "temperature": 0.0,
                                          "topP": 0.9, "stopSequences": ["x"]}
    assert "x-amz-security-token" in headers


def test_bedrock_chat_on_a_column_expression(fresh_port):
    def build(mod):
        def program(pw):
            t = pw.debug.table_from_markdown(QUESTIONS)
            chat = mod.BedrockChat(region="us-east-1", access_key="AK",
                                   secret_key="SK",
                                   _http=_recorder(_converse_reply)[1])
            return t.select(answer=chat(pw.this.prompt))
        return program

    [want] = capture("jax", build(jllms))
    [got] = capture("torch", build(tllms))
    assert got == want and ("re: which animal jumps",) in got.values()


def test_bedrock_chat_through_urllib_against_the_converse_stand_in():
    conv = chip_smoke.ConverseStandIn()
    try:
        key, secret, region = chip_smoke.AX_CREDS
        for mod in (jllms, tllms):
            chat = mod.BedrockChat(chip_smoke.AX_MODEL_ID, region=region,
                                   access_key=key, secret_key=secret,
                                   endpoint=conv.url)
            assert chat("what holds the keys") == chip_smoke.AX_CANNED
            bad = mod.BedrockChat(chip_smoke.AX_MODEL_ID, region=region,
                                  access_key=key, secret_key="wrong",
                                  endpoint=conv.url)
            with pytest.raises(urllib.error.HTTPError) as err:
                bad("what holds the keys")
            assert err.value.code == 403
        assert conv.bad == 2 and len(conv.payloads) == 2
        assert conv.payloads[0] == conv.payloads[1]
    finally:
        conv.close()


# -- the client-package chats and embedders ------------------------------------


def _fake_openai():
    calls = []

    class OpenAI:
        def __init__(self, api_key=None):
            self.api_key = api_key
            self.chat = types.SimpleNamespace(completions=types.SimpleNamespace(
                create=self._chat))
            self.embeddings = types.SimpleNamespace(create=self._embed)

        def _chat(self, **kw):
            calls.append(("chat", self.api_key, kw))
            msg = types.SimpleNamespace(
                content=f"openai: {kw['messages'][-1]['content']}")
            return types.SimpleNamespace(
                choices=[types.SimpleNamespace(message=msg)])

        def _embed(self, **kw):
            calls.append(("embed", self.api_key, kw))
            return types.SimpleNamespace(data=[types.SimpleNamespace(
                embedding=[float(len(kw["input"][0])), 0.5, -1.25])])

    mod = types.ModuleType("openai")
    mod.OpenAI = OpenAI
    return mod, calls


def _fake_litellm():
    calls = []
    mod = types.ModuleType("litellm")

    def completion(**kw):
        calls.append(("completion", kw))
        return {"choices": [{"message": {
            "content": f"litellm: {kw['messages'][-1]['content']}"}}]}

    def embedding(**kw):
        calls.append(("embedding", kw))
        return {"data": [{"embedding": [1.0, float(len(kw["input"][0]))]}]}

    mod.completion, mod.embedding = completion, embedding
    return mod, calls


def _both(monkeypatch, name, fake, run):
    """``run(module_pair)`` in each package with ``fake`` as ``name``:
    (result, the fake's calls) per package."""
    out = {}
    for pkg, mods in (("jax", (jllms, jemb)), ("torch", (tllms, temb))):
        mod, calls = fake()
        monkeypatch.setitem(sys.modules, name, mod)
        out[pkg] = (run(*mods), calls)
    return out


def _plain(x):
    return x.tolist() + [str(x.dtype)] if isinstance(x, np.ndarray) else x


def test_openai_chat_and_embedder_make_the_jax_calls(monkeypatch):
    out = _both(monkeypatch, "openai", _fake_openai, lambda llms, emb: [
        llms.OpenAIChat("gpt-x", api_key="k1", temperature=0.1,
                        capacity=2)("hello", max_tokens=5),
        llms.OpenAIChat(api_key="k2")([{"role": "user", "content": "hi"}]),
        _plain(emb.OpenAIEmbedder("e-1", api_key="k3", dimensions=3)("abc")),
        _plain(emb.OpenAIEmbedder()._embed("")),
        emb.OpenAIEmbedder(api_key="k").get_embedding_dimension(),
    ])
    assert out["torch"] == out["jax"]
    (answers, calls) = out["torch"]
    assert answers[0] == "openai: hello" and answers[2] == [3.0, 0.5, -1.25,
                                                            "float32"]
    assert calls[0] == ("chat", "k1", {"model": "gpt-x", "messages": [
        {"role": "user", "content": "hello"}], "temperature": 0.1,
        "max_tokens": 5})


def test_litellm_and_gemini_make_the_jax_calls(monkeypatch):
    out = _both(monkeypatch, "litellm", _fake_litellm, lambda llms, emb: [
        llms.LiteLLMChat("ollama/x", api_base="http://h")("hi", top_p=0.5),
        _plain(emb.LiteLLMEmbedder("m", api_base="http://h")("four")),
        _plain(emb.GeminiEmbedder()._embed("")),
    ])
    assert out["torch"] == out["jax"]
    answers, calls = out["torch"]
    assert answers == ["litellm: hi", [1.0, 4.0, "float32"],
                       [1.0, 1.0, "float32"]]
    assert calls[2] == ("embedding", {"model":
                                      "gemini/models/text-embedding-004",
                                      "input": [" "]})


@pytest.mark.parametrize("name", ["openai", "litellm"])
def test_an_absent_client_package_raises_alike(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, None)
    msgs = {}
    for pkg, llms, emb, parsers in (("jax", jllms, jemb, jparsers),
                                    ("torch", tllms, temb, tparsers)):
        if name == "openai":
            calls = (lambda: llms.OpenAIChat()("q"),
                     lambda: emb.OpenAIEmbedder()._embed("q"),
                     lambda: parsers.default_vision_llm()("q"))
        else:
            calls = (lambda: llms.LiteLLMChat("m")("q"),
                     lambda: emb.LiteLLMEmbedder("m")._embed("q"),
                     lambda: emb.GeminiEmbedder()._embed("q"))
        msgs[pkg] = []
        for call in calls:
            with pytest.raises(ImportError) as err:
                call()
            msgs[pkg].append(str(err.value))
    assert msgs["torch"] == msgs["jax"]


def test_the_clients_neither_package_carries_raise_alike():
    msgs = {}
    for pkg, llms, emb in (("jax", jllms, jemb), ("torch", tllms, temb)):
        msgs[pkg] = []
        for call in (lambda: llms.CohereChat("command-r")("q"),
                     lambda: emb.BedrockEmbedder()("q"),
                     lambda: emb.MarengoEmbedder("x", key=1)("q")):
            with pytest.raises(ImportError) as err:
                call()
            msgs[pkg].append(str(err.value))
    assert msgs["torch"] == msgs["jax"] and len(msgs["jax"]) == 3


def test_default_vision_llm_is_the_jax_chat():
    j, t = jparsers.default_vision_llm(), tparsers.default_vision_llm()
    assert isinstance(t, tllms.OpenAIChat) and isinstance(t, tllms.BaseChat)
    assert (t.model, t.api_key, t.kwargs) == (j.model, j.api_key, j.kwargs)


# -- AudioParser and TwelveLabsVideoParser -------------------------------------


AUDIO = [b"RIFF\x00\x00\x00\x00WAVE", b"OggS\x00\x02", b"fLaC\x00\x00",
         b"\x00\x00\x00\x20ftypM4A ", b"ID3\x04\x00", b"\xff\xfb\x90\x00",
         b"\xff\xf3\x00", b"unknown bytes"]


@pytest.mark.parametrize("filename", [None, "talk.ogg"])
def test_audio_parser_sends_the_jax_request(monkeypatch, filename):
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=0xABCDEF))
    monkeypatch.setenv("OPENAI_API_KEY", "sk-env")
    out = {}
    for pkg, mod in (("jax", jparsers), ("torch", tparsers)):
        seen, http = _recorder(lambda url, body, headers: {
            "text": f"{len(body)} bytes"})
        parser = mod.AudioParser(filename=filename, _http=http,
                                 base_url="https://h/v1/")
        out[pkg] = ([parser._parse(c) for c in AUDIO], seen)
    assert out["torch"] == out["jax"]
    _results, seen = out["torch"]
    names = [body.split(b'filename="')[1].split(b'"')[0] for _u, body, _h
             in seen]
    assert names == ([b"talk.ogg"] * len(AUDIO) if filename else [
        b"audio.wav", b"audio.ogg", b"audio.flac", b"audio.m4a",
        b"audio.mp3", b"audio.mp3", b"audio.mp3", b"audio.mp3"])
    assert seen[0][0] == "https://h/v1/audio/transcriptions"
    assert seen[0][2]["Authorization"] == "Bearer sk-env"


def test_audio_parser_through_urllib_and_an_http_error():
    texts = ["zero", "one", "two"]
    whisper = chip_smoke.WhisperStandIn(texts)
    failing = _FailingServer()
    try:
        media = chip_smoke.ax_media(np, 3, 2, 1, 4)
        files = [d for n, d in sorted(media["files"].items())
                 if not n.endswith(".webm")]
        whisper.texts = media["texts"]
        for mod in (jparsers, tparsers):
            parser = mod.AudioParser(api_key=chip_smoke.AX_KEYS[0],
                                     base_url=whisper.url + "/v1")
            assert [parser._parse(f) for f in files] == [
                [(media["texts"][i], {"model": "whisper-1"})] for i in (0, 1)]
            with pytest.raises(urllib.error.HTTPError) as err:
                mod.AudioParser(base_url=failing.url)._parse(files[0])
            assert err.value.code == 500
        assert whisper.bad == 0 and sum(whisper.requests.values()) == 4
    finally:
        whisper.close()
        failing.close()


class _FailingServer(chip_smoke.HttpStandIn):
    def handle(self, method, path, headers, body):
        return 500, {"error": {"message": "upstream failed"}}


def _twelvelabs(status_after):
    """A TwelveLabs seam whose task reports ``status_after[i]`` on poll i
    (the last one repeated)."""
    polls = []

    def reply(method, url, payload, headers):
        if method == "POST" and url.endswith("/tasks"):
            return {"_id": "t1", "status": "pending", "video_id": "v9"}
        if method == "GET":
            polls.append(url)
            status = status_after[min(len(polls), len(status_after)) - 1]
            return {"_id": "t1", "status": status, "video_id": "v9"}
        return {"data": f"a video of {len(payload['prompt'])} chars"}
    return reply


def test_twelvelabs_parser_makes_the_jax_calls(monkeypatch):
    monkeypatch.setenv("TWELVE_LABS_API_KEY", "tl-env")
    out = {}
    for pkg, mod in (("jax", jparsers), ("torch", tparsers)):
        seen, http = _recorder(_twelvelabs(["pending", "ready"]))
        parser = mod.TwelveLabsVideoParser(index_id="idx", prompt="say it",
                                           poll_interval_s=0.01, _http=http)
        out[pkg] = (parser._parse(b"\x1aE\xdf\xa3video"), seen)
    assert out["torch"] == out["jax"]
    result, seen = out["torch"]
    assert result == [("a video of 6 chars", {"video_id": "v9"})]
    assert [s[0] for s in seen] == ["POST", "GET", "GET", "POST"]
    assert seen[0][3] == {"x-api-key": "tl-env",
                          "Content-Type": "application/json"}


@pytest.mark.parametrize("case", ["failed", "timeout"])
def test_a_twelvelabs_task_that_fails_or_times_out_raises_alike(case):
    errors = {}
    for pkg, mod in (("jax", jparsers), ("torch", tparsers)):
        status = ["pending", "failed"] if case == "failed" else ["pending"]
        parser = mod.TwelveLabsVideoParser(
            poll_interval_s=0.01, max_wait_s=0.03,
            _http=_twelvelabs(status))
        with pytest.raises((RuntimeError, TimeoutError)) as err:
            parser._parse(b"video")
        errors[pkg] = (type(err.value), str(err.value))
    assert errors["torch"] == errors["jax"]
    assert errors["torch"][0] is (RuntimeError if case == "failed"
                                  else TimeoutError)


def test_twelvelabs_parser_through_urllib_against_the_stand_in():
    media = chip_smoke.ax_media(np, 4, 0, 2, 5)
    tl = chip_smoke.TwelveLabsStandIn(media["texts"])
    try:
        videos = [d for _n, d in sorted(media["files"].items())]
        got = {}
        for pkg, mod in (("jax", jparsers), ("torch", tparsers)):
            parser = mod.TwelveLabsVideoParser(
                api_key=chip_smoke.AX_KEYS[1], base_url=tl.url + "/v1.3",
                poll_interval_s=0.01)
            got[pkg] = [parser._parse(v) for v in videos]
        assert got["torch"] == got["jax"] == [
            [(media["texts"][i], {"video_id": f"video{i}"})] for i in (0, 1)]
        assert (tl.bad, len(tl.tasks), tl.polls, tl.generates) == (0, 4, 8, 4)
    finally:
        tl.close()


# -- the local models: HFPipelineChat and HFTokenizer --------------------------


@pytest.fixture(scope="module")
def hf_chat_dir(tmp_path_factory):
    """A random tiny GPT-2 LM and a word-level tokenizer saved together."""
    import tokenizers
    import transformers

    vocab = ["[PAD]", "[UNK]", "<eos>"] + [f"w{i}" for i in range(40)] + [
        "the", "question", "is", "what", "?", ":"]
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {w: i for i, w in enumerate(vocab)}, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    path = tmp_path_factory.mktemp("hfchat")
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="[UNK]", pad_token="[PAD]",
        eos_token="<eos>").save_pretrained(path)
    torch.manual_seed(0)
    transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=len(vocab), n_embd=32, n_layer=2, n_head=4,
        n_positions=64, bos_token_id=2, eos_token_id=2, pad_token_id=0,
    )).save_pretrained(path)
    return str(path)


def test_hf_pipeline_chat_answers_as_the_jax_one(hf_chat_dir):
    kw = dict(call_kwargs={"max_new_tokens": 5, "do_sample": False})
    jchat = jllms.HFPipelineChat(hf_chat_dir, **kw)
    tchat = tllms.HFPipelineChat(hf_chat_dir, device="cpu", **kw)
    messages = [{"role": "system", "content": "w1 w2"},
                {"role": "user", "content": "what is the question ?"}]
    for call in (lambda c: c(messages), lambda c: c("w3 w4 w5"),
                 lambda c: c("w6", max_new_tokens=3)):
        want = call(jchat)
        assert call(tchat) == want and want.startswith(("w1", "w3", "w6"))
    # the port's entry points run on the card unless asked for the CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllms.HFPipelineChat(hf_chat_dir)


def test_hf_tokenizer_encodes_as_the_jax_one(hf_chat_dir):
    j, t = jtok.HFTokenizer(hf_chat_dir), ttok.HFTokenizer(hf_chat_dir)
    text = "what is the question ? w1 w39 unseen"
    assert t.vocab_size == j.vocab_size == 49
    assert t.encode(text) == j.encode(text) and 1 in t.encode(text)
    assert t.count_tokens(text) == j.count_tokens(text) == 8


# -- the package surface: the python subject, sync groups, the store ----------


def test_interactive_csv_player_and_remove_give_the_jax_table(
        tmp_path, fresh_port):
    path = tmp_path / "rows.csv"
    path.write_text("k,name,n\n1,ann,3\n2,bob,5\n3,cyd,8\n")

    def build(pw):
        class S(pw.Schema):
            k: int = pw.column_definition(primary_key=True)
            name: str
            n: int

        class Pruner(pw.io.python.ConnectorSubject):
            def run(self):
                for k in (1, 2, 3):
                    self.next(k=k, name=f"r{k}", n=k)
                self._remove(k=2, name="r2", n=2)
                self.remove(k=3, name="r3", n=3)

        played = pw.io.python.read(
            pw.io.python.InteractiveCsvPlayer(str(path), speedup=1000.0),
            schema=S)
        return played, pw.io.python.read(Pruner(), schema=S)

    want = capture("jax", build)
    got = capture("torch", build)
    assert got == want
    assert sorted(got[0].values()) == [(1, "ann", 3), (2, "bob", 5),
                                       (3, "cyd", 8)]
    assert list(got[1].values()) == [(1, "r1", 1)]


def test_clear_groups_drops_the_registered_groups(fresh_port):
    from pathway_tpu.io import _synchronization as jsync
    from pathway_tpu_torch.internals import parse_graph as tpg
    from pathway_tpu_torch.io import _synchronization as tsync

    for pw, sync, groups in ((jpw, jsync, lambda: jsync._groups),
                             (tpw, tsync, lambda: tpg.G.sync_groups)):
        a = pw.debug.table_from_markdown("t\n1")
        b = pw.debug.table_from_markdown("t\n2")
        sync.register_input_synchronization_group(a.t, b.t, max_difference=1)
        assert len(groups()) == 1
        sync.clear_groups()
        assert groups() == []


def test_n_batches_counts_the_jax_buffers():
    import jax.numpy as jnp

    from pathway_tpu.ops.device_store import DeviceVecStore as JStore
    from pathway_tpu_torch.ops.device_store import DeviceVecStore as TStore

    j, t = JStore(4), TStore(4, device="cpu")
    j.BUF_ROWS = t.BUF_ROWS = 4
    counts = []
    for rows in (0, 3, 1, 2, 4):
        if rows:
            j.append_batch(jnp.ones((rows, 4), jnp.float32))
            t.append_batch(torch.ones((rows, 4)))
        counts.append((j.n_batches(), t.n_batches()))
    assert [a for a, _b in counts] == [b for _a, b in counts] == [0, 1, 1, 2,
                                                                  3]


def test_the_exported_names_are_the_submodules_own():
    from pathway_tpu_torch import kvcache, serve
    from pathway_tpu_torch.kvcache import engine, paged_attention, speculative
    from pathway_tpu_torch.serve import metrics

    assert serve.render_prometheus_lines is metrics.render_prometheus_lines
    assert all(isinstance(x, str) for x in serve.render_prometheus_lines())
    assert kvcache.resolve_tp is engine.resolve_tp
    assert kvcache.SpecResourceError is speculative.SpecResourceError
    assert issubclass(kvcache.SpecResourceError, RuntimeError)
    assert kvcache.paged_attention_reference is \
        paged_attention.paged_attention_reference
    cfg = tdec.DecoderConfig(**DEC)
    assert kvcache.resolve_tp(cfg, None) == 1
