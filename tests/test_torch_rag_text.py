"""The port's parsers, splitters and prompt templates against the JAX
package's functions on the same inputs: equal outputs, and one
hypothesis property over strings for each chunking splitter; both
called on a column expression inside each package's own dataflow."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine import runner as jrunner
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu.xpacks.llm import parsers as jparsers
from pathway_tpu.xpacks.llm import prompts as jprompts
from pathway_tpu.xpacks.llm import splitters as jsplit
from pathway_tpu_torch.engine import runner as trunner
from pathway_tpu_torch.internals import parse_graph as tpg
from pathway_tpu_torch.xpacks.llm import parsers as tparsers
from pathway_tpu_torch.xpacks.llm import prompts as tprompts
from pathway_tpu_torch.xpacks.llm import splitters as tsplit

TEXT = ("Pathway processes live data.\n\nIt keeps an index fresh as "
        "documents change. Queries see the newest version.\nEach answer "
        "cites its sources. " * 6)

SPLITTERS = {
    "null": ({}, "NullSplitter"),
    "tokens": (dict(min_tokens=5, max_tokens=12), "TokenCountSplitter"),
    "tokens_default": ({}, "TokenCountSplitter"),
    "recursive": (dict(chunk_size=15), "RecursiveSplitter"),
    "recursive_overlap": (dict(chunk_size=9, chunk_overlap=3,
                               separators=["\n\n", ". ", " "]),
                          "RecursiveSplitter"),
}


@pytest.mark.parametrize("name", sorted(SPLITTERS))
def test_splitters_split_as_the_jax_ones(name):
    kw, cls = SPLITTERS[name]
    got = getattr(tsplit, cls)(**kw)(TEXT)
    assert got == getattr(jsplit, cls)(**kw)(TEXT)
    assert got and all(isinstance(c, str) and m == {} for c, m in got)


_words = st.lists(st.sampled_from(["a", "bb", "ccc", ". ", "\n", "\n\n",
                                   " ", "dd.", "é"]), max_size=80)


@settings(max_examples=60, deadline=None)
@given(text=_words.map("".join), size=st.integers(1, 12),
       overlap=st.integers(0, 3), min_tokens=st.integers(0, 6))
def test_chunking_splitters_agree_on_any_text(text, size, overlap,
                                              min_tokens):
    for cls, kw in (("TokenCountSplitter",
                     dict(min_tokens=min_tokens, max_tokens=size)),
                    ("RecursiveSplitter",
                     dict(chunk_size=size, chunk_overlap=overlap))):
        assert (getattr(tsplit, cls)(**kw)(text)
                == getattr(jsplit, cls)(**kw)(text)), (cls, kw)


@pytest.mark.parametrize("contents", [b"plain ascii", "café".encode(),
                                      b"bad \xff\xfe bytes", b""])
def test_utf8_parser_parses_as_the_jax_one(contents):
    assert tparsers.Utf8Parser()(contents) == jparsers.Utf8Parser()(contents)
    assert tparsers.ParseUtf8 is tparsers.Utf8Parser


PROMPTS = {
    "prompt_qa": (("what is x", ["doc one", "doc two"]), {}),
    "prompt_qa_custom": (("what is x", ["d"]),
                         {"info_not_found_response": "none"}),
    "prompt_short_qa": (("q", ["a", "b"]), {}),
    "prompt_citing_qa": (("q", ["a", "b", "c"]), {}),
    "prompt_summarize": ((["t1", "t2"],), {}),
    "prompt_query_rewrite_hyde": (("how do tpus work",), {}),
}


@pytest.mark.parametrize("name", sorted(PROMPTS))
def test_prompts_equal_the_jax_ones(name):
    args, kw = PROMPTS[name]
    fn = name.replace("_custom", "")
    assert getattr(tprompts, fn)(*args, **kw) == \
        getattr(jprompts, fn)(*args, **kw)


def test_parser_and_splitter_on_columns_in_each_dataflow():
    """Parse bytes and split the text inside each package's engine."""
    out = {}
    for pkg, (pw, runner, pg, parsers, splitters) in {
            "jax": (jpw, jrunner, jpg, jparsers, jsplit),
            "torch": (tpw, trunner, tpg, tparsers, tsplit)}.items():
        pg.G.clear()

        class S(pw.Schema):
            data: bytes

        t = pw.debug.table_from_rows(S, [(TEXT.encode(),), (b"one two",)])
        parsed = t.select(chunks=parsers.Utf8Parser()(t.data))
        parsed = parsed.flatten(parsed.chunks)
        split = parsed.select(pieces=splitters.TokenCountSplitter(
            min_tokens=3, max_tokens=10)(parsed.chunks[0]))
        kw = {"device": "cpu"} if pkg == "torch" else {}
        [cap] = runner.run_tables(split, **kw)
        out[pkg] = sorted(row[0] for row in cap.squash().values())
        pg.G.clear()
    assert out["torch"] == out["jax"] and len(out["torch"]) == 2
