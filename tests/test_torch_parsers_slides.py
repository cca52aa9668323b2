"""The port's parsers, licence gates, ``SlidesDocumentStore`` and
``DeckRetriever`` against the JAX package's.

- the native PDF extractor (FlateDecode streams, raw streams, ``TJ``
  arrays and escapes), ``PypdfParser`` over it (pypdf is not installed
  here), ``UnstructuredParser`` / ``ParseUnstructured`` (UTF-8 without
  ``unstructured``): equal outputs on the same bytes;
- ``ImageParser`` and ``SlideParser`` with the port's ``TorchClip``
  against the JAX package's ``JaxClip`` on one converted tree (16:9 PPM
  frames, so the resize runs, and a PNG through pillow): texts and sizes
  equal, embeddings within ``rtol=atol=1e-5``;
- ``PaddleOCRParser``'s native engine on ``tests/test_ocr.py``'s renders,
  under that file's skip condition (pillow): the same strings;
- the licence gates: no key raises ``MissingLicenseError``, the demo key
  and a signed offline key are accepted, a malformed key is rejected, a
  missing entitlement raises ``InsufficientLicenseError``: the same
  outcome and message in both packages;
- ``SlidesDocumentStore.parsed_documents_query`` and ``DeckRetriever``
  through each package's dataflow: equal captures.
"""

import zlib

import jax
import numpy as np
import pytest
import torch

from pathway_tpu.internals import config as jconfig
from pathway_tpu.internals import licensing as jlic
from pathway_tpu.models import clip as jclip
from pathway_tpu.xpacks.llm import parsers as jparsers
from pathway_tpu_torch.internals import config as tconfig
from pathway_tpu_torch.internals import licensing as tlic
from pathway_tpu_torch.models import clip as tclip
from pathway_tpu_torch.models.convert import clip_params_from_numpy
from pathway_tpu_torch.xpacks.llm import parsers as tparsers

from .torch_parity import capture, equal_to_jax, fresh_port  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _pdf(*streams: bytes) -> bytes:
    body = b"%PDF-1.4\n"
    for i, s in enumerate(streams):
        body += (f"{i + 4} 0 obj\n<< /Length {len(s)} >>\nstream\n".encode()
                 + s + b"\nendstream\nendobj\n")
    return body + b"%%EOF\n"


PAGE1 = b"BT /F1 12 Tf (Hello \\(PDF\\) world) Tj ET"
PAGE2 = b"BT [(Kerned) -120 ( text) 40 (!)] TJ (second\\nline) ' ET"
PAGE3 = b"q 1 0 0 1 0 0 cm Q"  # no text operators at all


@pytest.mark.parametrize("streams", [
    (zlib.compress(PAGE1), zlib.compress(PAGE2)),
    (PAGE1, zlib.compress(PAGE2), PAGE3),  # a raw stream is read raw
    (b"x\x9c not really deflate " + PAGE1,),  # a zlib.error: read raw
    (),
])
def test_native_pdf_extract_and_pypdf_parser_match_jax(streams):
    pdf = _pdf(*streams)
    got = tparsers._native_pdf_extract(pdf)
    assert got == jparsers._native_pdf_extract(pdf)
    if streams and streams[0].endswith(PAGE1):
        assert got[0].startswith("Hello (PDF) world")
    for cleanup in (True, False):
        assert (tparsers.PypdfParser(apply_text_cleanup=cleanup)._parse(pdf)
                == jparsers.PypdfParser(apply_text_cleanup=cleanup)._parse(pdf))


@pytest.mark.parametrize("mode", ["single", "elements"])
def test_unstructured_parsers_match_jax(mode):
    data = "plain text\n\nwith two paragraphs é".encode()
    for make in ("UnstructuredParser", "ParseUnstructured"):
        assert (getattr(tparsers, make)(mode=mode)._parse(data)
                == getattr(jparsers, make)(mode=mode)._parse(data))


def _small(mod, dtype):
    return mod.ClipConfig(
        vision=mod.ClipVisionConfig(image_size=32, patch_size=8, d_model=64,
                                    n_layers=2, n_heads=4, d_ff=128),
        text=mod.ClipTextConfig(vocab_size=2048, max_len=16, d_model=64,
                                n_layers=2, n_heads=4, d_ff=128),
        projection_dim=32, dtype=dtype)


@pytest.fixture(scope="module")
def clips():
    """(JaxClip, TorchClip) on one random JAX tree."""
    cfg_j = _small(jclip, np.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jclip.init_clip_params(cfg_j, jax.random.PRNGKey(5)))
    cfg_t = _small(tclip, torch.float32)
    return (jclip.JaxClip(cfg_j, params=jax.tree_util.tree_map(
                jax.numpy.asarray, tree)),
            tclip.TorchClip(cfg_t, params=clip_params_from_numpy(
                tree, cfg_t, device="cpu"), device="cpu"))


def _ppm(rng, w=48, h=27) -> bytes:
    px = (rng.random((h, w, 3)) * 255).astype(np.uint8)
    return f"P6\n{w} {h}\n255\n".encode() + px.tobytes()


def _same_parse(got, want):
    assert [t for t, _m in got] == [t for t, _m in want]
    for (_t, m), (_jt, jm) in zip(got, want):
        assert {k: v for k, v in m.items() if k != "clip_embedding"} == {
            k: v for k, v in jm.items() if k != "clip_embedding"}
        np.testing.assert_allclose(np.asarray(m["clip_embedding"]),
                                   np.asarray(jm["clip_embedding"]), **TOL)


def test_image_parser_matches_jax(clips):
    import io

    from PIL import Image

    jc, tc = clips
    rng = np.random.default_rng(0)
    ppm = _ppm(rng)
    _same_parse(tparsers.ImageParser(clip_model=tc)(ppm),
                jparsers.ImageParser(clip_model=jc)(ppm))
    buf = io.BytesIO()
    Image.fromarray((rng.random((20, 30, 3)) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    png = buf.getvalue()
    got = tparsers.ImageParser(clip_model=tc)(png)
    _same_parse(got, jparsers.ImageParser(clip_model=jc)(png))
    assert got[0][0] == "image 30x20"
    # a vision chat instead of (and after) CLIP: its answer is the text
    chat = lambda messages: "a chart"  # noqa: E731
    assert (tparsers.ImageParser(llm=chat)(ppm)
            == jparsers.ImageParser(llm=chat)(ppm) == [("a chart", {})])
    both = tparsers.ImageParser(llm=chat, clip_model=tc)(ppm)
    _same_parse(both, jparsers.ImageParser(llm=chat, clip_model=jc)(ppm))
    for mod in (tparsers, jparsers):
        with pytest.raises(ValueError, match="clip_model"):
            mod.ImageParser()(ppm)


def test_slide_parser_matches_jax(clips):
    jc, tc = clips
    rng = np.random.default_rng(1)
    pages = [_ppm(rng) for _ in range(3)] + [_ppm(rng, 32, 18)]
    deck = b"".join(pages)
    got = tparsers.SlideParser(clip_model=tc)(deck)
    _same_parse(got, jparsers.SlideParser(clip_model=jc)(deck))
    assert [m["page"] for _t, m in got] == [0, 1, 2, 3]
    assert tparsers.SlideParser()._split_pages(deck) == pages
    # each page's embedding is its frame's row of one batched forward
    frames = [tparsers._decode_image(p) for p in pages]
    np.testing.assert_allclose(
        np.stack([m["clip_embedding"] for _t, m in got]),
        tc.embed_image_batch(frames), rtol=0, atol=0)
    # a lone non-PPM page passes through as one image
    assert tparsers.SlideParser()._split_pages(b"\x89PNG...") == [b"\x89PNG..."]


def test_paddle_ocr_native_engine_matches_jax():
    pytest.importorskip("PIL")
    import io

    from PIL import Image

    from .test_ocr import _mono, _render

    for lines, size in ((["invoice total: 1234"], 20),
                        (["Hello World 42: the quick brown fox",
                          "jumps over the LAZY dog"], 18)):
        buf = io.BytesIO()
        Image.fromarray(_render(lines, _mono(size))).save(buf, format="PNG")
        png = buf.getvalue()
        got = tparsers.PaddleOCRParser()._parse(png)
        assert got == jparsers.PaddleOCRParser()._parse(png)
        assert got[0][1] == {"engine": "native-template"}
        assert got[0][0]


# -- the licence gates -------------------------------------------------------

GATED = {
    "DoclingParser": lambda p: p.DoclingParser(),
    "PaddleOCRParser": lambda p: p.PaddleOCRParser(),
}


def _outcome(config, parsers, make):
    try:
        GATED[make](parsers)
    except Exception as exc:  # noqa: BLE001 - compared across packages
        return type(exc).__name__, str(exc)
    return "ok", None


@pytest.mark.parametrize("make", sorted(GATED))
def test_license_gates_match_jax(make, monkeypatch):
    monkeypatch.delenv("PATHWAY_LICENSE_SIGNING_KEY", raising=False)
    for cfg in (jconfig, tconfig):
        monkeypatch.setattr(cfg.pathway_config, "license_key", None)
    pairs = ((jconfig, jparsers), (tconfig, tparsers))
    outcomes = [_outcome(c, p, make) for c, p in pairs]
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0] == "MissingLicenseError"
    for cfg in (jconfig, tconfig):
        cfg.set_license_key("demo-license-key-with-telemetry")
    assert [_outcome(c, p, make) for c, p in pairs] == [("ok", None)] * 2
    # a signed offline key, with the signing key set
    monkeypatch.setenv("PATHWAY_LICENSE_SIGNING_KEY", "s3cret")
    key = tlic.sign_offline_key("advanced-parser,xpack-llm-mcp", "s3cret")
    assert key == jlic.sign_offline_key("advanced-parser,xpack-llm-mcp",
                                        "s3cret")
    for cfg in (jconfig, tconfig):
        cfg.set_license_key(key)
    assert [_outcome(c, p, make) for c, p in pairs] == [("ok", None)] * 2
    # signed for another feature only: insufficient
    other = tlic.sign_offline_key("kinesis", "s3cret")
    for cfg in (jconfig, tconfig):
        cfg.set_license_key(other)
    outcomes = [_outcome(c, p, make) for c, p in pairs]
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0] == "InsufficientLicenseError"
    # a malformed or unsigned key is rejected when set
    for bad in ("pathway-tpu:v1:advanced-parser", key[:-2] + "00",
                "demo-license-key-no-telemetry"):
        errors = []
        for lic, cfg in ((jlic, jconfig), (tlic, tconfig)):
            with pytest.raises(lic.LicenseError) as info:
                cfg.set_license_key(bad)
            errors.append((type(info.value).__name__, str(info.value)))
        assert errors[0] == errors[1]
    monkeypatch.delenv("PATHWAY_LICENSE_SIGNING_KEY")
    for lic in (jlic, tlic):
        with pytest.raises(lic.InsufficientLicenseError, match="malformed"):
            lic.parse_license("pathway-tpu:v1:a:b:c")


def test_unknown_license_key_warns_in_good_faith(caplog):
    import logging

    with caplog.at_level(logging.WARNING, tlic.__name__):
        lic = tlic.parse_license("totally-made-up-key-123")
    assert lic is not None and lic.allows("advanced-parser")
    assert any("not a recognized" in r.message for r in caplog.records)


def test_set_license_key_is_exported():
    import pathway_tpu_torch as pw

    assert pw.set_license_key is tconfig.set_license_key


# -- SlidesDocumentStore and DeckRetriever through the dataflow --------------

class _OnesEmbedder:
    """A constant text embedder, built in whichever package it is given."""

    def __init__(self, pw):
        self.pw = pw

    def get_embedding_dimension(self):
        return 4

    def __call__(self, col):
        from importlib import import_module

        mod = import_module(self.pw.__name__ + ".internals.expression")
        dt = import_module(self.pw.__name__ + ".internals.dtype")
        return mod.ApplyExpression(lambda t: np.ones(4, np.float32),
                                   dt.ANY_ARRAY, (col,), {})


def _llm(pw):
    from importlib import import_module

    return import_module(pw.__name__ + ".xpacks.llm")


SLIDE_TEXTS = [
    ("quarterly revenue grew in the north region", "deck_a.pdf", 1),
    ("the roadmap names three launches", "deck_a.pdf", 2),
    ("hiring plan for the platform team", "deck_b.pdf", 1),
    ("revenue forecast for next year", "deck_b.pdf", 2),
]


def _slide_docs(pw):
    class DS(pw.Schema):
        data: str
        _metadata: object

    return pw.debug.table_from_rows(DS, [
        (t, pw.Json({"path": p, "page": n, "b64_image": "HUGE"}))
        for t, p, n in SLIDE_TEXTS])


def test_parsed_documents_query_matches_jax(monkeypatch,
                                            fresh_port):  # noqa: F811
    def build(pw):
        llm = _llm(pw)
        store = llm.document_store.SlidesDocumentStore(
            _slide_docs(pw),
            retriever_factory=pw.indexing.TantivyBM25Factory())

        class QS(pw.Schema):
            metadata_filter: str | None

        q = pw.debug.table_from_rows(QS, [
            ("page == `1`",), ("globmatch('deck_b*', path)",), (None,)])
        return store.parsed_documents_query(q)

    [got] = equal_to_jax(build, monkeypatch)
    results = sorted((len(r[0].value), tuple(sorted(m["path"] + str(m["page"])
                                                    for m in r[0].value)))
                     for r in got.values())
    assert [n for n, _ in results] == [2, 2, 4]
    assert all("b64_image" not in m for r in got.values() for m in r[0].value)


def test_deck_retriever_matches_jax(monkeypatch, fresh_port):  # noqa: F811
    def build(pw):
        llm = _llm(pw)
        store = llm.document_store.SlidesDocumentStore(
            _slide_docs(pw),
            retriever_factory=pw.indexing.TantivyBM25Factory())
        deck = llm.question_answering.DeckRetriever(None, store,
                                                    search_topk=2)

        class PS(pw.Schema):
            prompt: str

        prompts = pw.debug.table_from_rows(
            PS, [("revenue",), ("roadmap launches",)])

        class RS(pw.Schema):
            query: str
            k: int

        retrieves = pw.debug.table_from_rows(
            RS, [("revenue", 2), ("roadmap launches", 2)])
        return deck.answer_query(prompts), store.retrieve_query(retrieves)

    answers, retrieved = equal_to_jax(build, monkeypatch)
    got = sorted([d["text"] for d in r[0].value] for r in answers.values())
    want = sorted([d["text"] for d in r[0].value] for r in retrieved.values())
    assert got == want and sorted(len(g) for g in got) == [1, 2]


def test_slides_store_over_the_clip_slide_parser_matches_jax(
        clips, monkeypatch, fresh_port):  # noqa: F811
    """P6 decks as binary documents through ``SlideParser`` over CLIP into
    each package's ``SlidesDocumentStore``: the parsed pages' metadata
    equal, their embeddings within 1e-5, and a jmespath filter on the
    path returns one deck's pages."""
    jc, tc = clips
    rng = np.random.default_rng(4)
    decks = [(f"deck{i}.ppm", b"".join(_ppm(rng) for _ in range(3)))
             for i in range(3)]

    def build(pw):
        llm = _llm(pw)
        clip = jc if pw.__name__ == "pathway_tpu" else tc

        class DS(pw.Schema):
            data: bytes
            _metadata: object

        docs = pw.debug.table_from_rows(
            DS, [(b, pw.Json({"path": p})) for p, b in decks])
        store = llm.document_store.SlidesDocumentStore(
            docs, parser=llm.parsers.SlideParser(clip_model=clip),
            retriever_factory=pw.indexing.BruteForceKnnFactory(
                dimensions=4, embedder=_OnesEmbedder(pw),
                **({} if pw.__name__ == "pathway_tpu" else {"device": "cpu"})))

        class QS(pw.Schema):
            metadata_filter: str | None

        q = pw.debug.table_from_rows(
            QS, [("path == 'deck1.ppm'",), (None,)])
        return store.parsed_documents_query(q)

    [want] = capture("jax", build)
    [got] = capture("torch", build, monkeypatch=monkeypatch)
    assert sorted(got) == sorted(want)
    for key, (res,) in got.items():
        metas, jmetas = res.value, want[key][0].value
        assert len(metas) == len(jmetas) in (3, 9)
        for m, jm in zip(metas, jmetas):
            assert ({k: v for k, v in m.items() if k != "clip_embedding"}
                    == {k: v for k, v in jm.items() if k != "clip_embedding"})
            np.testing.assert_allclose(np.asarray(m["clip_embedding"]),
                                       np.asarray(jm["clip_embedding"]),
                                       **TOL)


def test_json_metadata_hash_is_serialized_once_and_matches_jax(monkeypatch):
    """A page's metadata holds its CLIP embedding; the engine hashes the
    row at every consolidation.  The port's ``Json`` serializes its value
    once per object for that, and the hash stays the JAX package's."""
    import json as _json

    from pathway_tpu.internals.value import Json as JJson
    from pathway_tpu.internals.value import hash_values as jhash
    from pathway_tpu_torch.internals.value import Json, hash_values

    meta = {"path": "/decks/a.ppm", "page": 2,
            "clip_embedding": np.linspace(-1, 1, 512, dtype=np.float32)}
    want = (hash(JJson(meta)), jhash(JJson(meta)), hash(JJson({"page": 3})))
    j = Json(meta)
    calls = []
    real = _json.dumps
    monkeypatch.setattr(_json, "dumps",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    first = hash(j)
    assert [hash(j), hash_values(j), hash_values((j, 1))][0] == first
    assert len(calls) == 1
    assert (first, hash_values(j)) == want[:2]
    j.value = {"page": 3}  # a new value is serialized anew
    assert hash(j) == want[2] and len(calls) == 2
