"""Document parsers (the port of ``pathway_tpu/xpacks/llm/parsers.py``;
reference: xpacks/llm/parsers.py:55-1170).

A parser maps bytes to ``[(text, metadata)]`` and is callable on column
expressions.  Ported: ``Utf8Parser``; ``PypdfParser`` over a native
extractor of FlateDecode text streams (pypdf when it is installed);
``UnstructuredParser`` / ``ParseUnstructured`` (UTF-8 when
``unstructured`` is absent, as in the JAX package); ``DoclingParser``
(licence-gated, raises without docling); ``ImageParser`` and
``SlideParser`` over the port's ``TorchClip`` (PPM decodes natively,
other formats through pillow; a slide deck's pages are embedded in one
``embed_image_batch`` forward); ``PaddleOCRParser`` (paddleocr when
installed, else the native template engine of ``_ocr.py``);
``default_vision_llm`` (an ``OpenAIChat``); ``AudioParser`` (OpenAI's
Whisper transcription endpoint, one multipart POST a file) and
``TwelveLabsVideoParser`` (TwelveLabs' task API: upload, poll until
ready, generate), both spoken over ``urllib`` with an ``_http`` test
seam.
"""

from __future__ import annotations

import base64
import json
import os
import time
import urllib.request
import uuid
import zlib

from ...internals import dtype as dt
from ...internals.expression import ApplyExpression, ColumnExpression
from ...internals.value import Json


class ParserBase:
    def _parse(self, contents: bytes) -> list[tuple[str, dict]]:
        raise NotImplementedError

    def __call__(self, contents, **kwargs):
        if isinstance(contents, ColumnExpression):
            def fn(c):
                if isinstance(c, str):
                    c = c.encode()
                return tuple((t, Json(m)) for t, m in self._parse(c or b""))

            return ApplyExpression(fn, dt.List(dt.ANY), (contents,), {},
                                   propagate_none=True)
        return self._parse(contents)


class Utf8Parser(ParserBase):
    """Decode bytes as UTF-8 text (reference: Utf8Parser / ParseUtf8)."""

    def _parse(self, contents: bytes):
        return [(contents.decode("utf-8", errors="replace"), {})]


ParseUtf8 = Utf8Parser


def _native_pdf_extract(contents: bytes) -> list[str]:
    """Dependency-free PDF text extraction: inflate FlateDecode content
    streams and read the text-showing operators (Tj / TJ / ').  A stream
    that does not inflate (``zlib.error``) is read raw, as an uncompressed
    one is.  Covers straightforwardly-encoded PDFs; complex encodings (CID
    fonts, octal-heavy escapes) degrade to partial text."""
    import re as _re

    texts: list[str] = []
    for m in _re.finditer(rb"stream\r?\n(.*?)endstream", contents, _re.S):
        data = m.group(1)
        try:
            data = zlib.decompress(data)
        except zlib.error:
            pass  # not FlateDecode: the stream's bytes are the content
        chunks: list[str] = []
        # (string) Tj   and   [(a) -120 (b)] TJ
        for sm in _re.finditer(
            rb"\((?:\\.|[^\\()])*\)\s*(?:Tj|')|\[(?:[^\]]*)\]\s*TJ", data
        ):
            frag = sm.group(0)
            for lit in _re.finditer(rb"\((?:\\.|[^\\()])*\)", frag):
                raw = lit.group(0)[1:-1]
                raw = _re.sub(
                    rb"\\([nrtbf()\\])",
                    lambda e: {b"n": b"\n", b"r": b"\r", b"t": b"\t",
                               b"b": b"\b", b"f": b"\f", b"(": b"(",
                               b")": b")", b"\\": b"\\"}[e.group(1)],
                    raw,
                )
                chunks.append(raw.decode("latin-1", "replace"))
            chunks.append(" ")
        text = "".join(chunks).strip()
        if text:
            texts.append(text)
    return texts


class PypdfParser(ParserBase):
    """pypdf when importable; otherwise the native extractor above."""

    def __init__(self, apply_text_cleanup: bool = True, cache_strategy=None):
        self.cleanup = apply_text_cleanup

    def _parse(self, contents: bytes):
        try:
            import io

            from pypdf import PdfReader
        except ImportError:
            pages = _native_pdf_extract(contents)
            out = []
            for i, text in enumerate(pages or [""]):
                if self.cleanup:
                    text = " ".join(text.split())
                out.append((text, {"page": i}))
            return out
        reader = PdfReader(io.BytesIO(contents))
        out = []
        for i, page in enumerate(reader.pages):
            text = page.extract_text() or ""
            if self.cleanup:
                text = " ".join(text.split())
            out.append((text, {"page": i}))
        return out


class UnstructuredParser(ParserBase):
    def __init__(self, mode: str = "single", post_processors=None, **kwargs):
        self.mode = mode

    def _parse(self, contents: bytes):
        try:
            from unstructured.partition.auto import partition
        except ImportError:
            # the JAX package's documented fallback: UTF-8 text
            return Utf8Parser()._parse(contents)
        import io

        elements = partition(file=io.BytesIO(contents))
        if self.mode == "single":
            return [("\n\n".join(str(e) for e in elements), {})]
        return [(str(e), {"category": getattr(e, "category", None)})
                for e in elements]


class DoclingParser(ParserBase):
    def __init__(self, **kwargs):
        from ...internals.config import _check_entitlements

        _check_entitlements("advanced-parser")

    def _parse(self, contents):
        raise ImportError("DoclingParser requires the docling package")


def _decode_image(contents: bytes):
    """Image bytes -> (H, W, 3) float array.  PPM (P6) decodes natively;
    other formats go through PIL when installed."""
    import numpy as np

    if contents[:2] == b"P6":
        # dependency-free PPM: header lines (magic, dims, maxval), raw RGB
        parts = contents.split(b"\n", 3)
        w, h = (int(x) for x in parts[1].split())
        data = parts[3][: w * h * 3]
        return np.frombuffer(data, np.uint8).reshape(h, w, 3).astype(
            np.float32
        ) / 255.0
    try:
        import io

        from PIL import Image

        im = Image.open(io.BytesIO(contents)).convert("RGB")
        return np.asarray(im, np.float32) / 255.0
    except ImportError as exc:
        raise ImportError(
            "decoding this image format needs pillow (PPM works natively)"
        ) from exc


class ImageParser(ParserBase):
    """Image parsing (reference ImageParser, parsers.py:55-1170).

    Two modes, composable:
      - clip_model (``models/clip.py`` ``TorchClip``): the image embeds
        into the shared text/image space; the embedding rides the
        metadata as ``clip_embedding``, so a DocumentStore indexes images
        retrievable by text queries, with no outside vision service;
      - llm: a multimodal chat generates the description (the reference's
        only mode: an outside vision LLM called with base64 payloads).
    """

    def __init__(self, llm=None, prompt: str = "Describe this image.",
                 clip_model=None, **kwargs):
        self.llm = llm
        self.prompt = prompt
        self.clip = clip_model

    def _parse(self, contents):
        return self._parse_images([contents])

    def _parse_images(self, images: list[bytes]) -> list[tuple[str, dict]]:
        """One ``(text, metadata)`` an image; with a clip model every
        image is embedded in one ``embed_image_batch`` call."""
        metas: list[dict] = [{} for _ in images]
        texts: list[str | None] = [None] * len(images)
        if self.clip is not None:
            frames = [_decode_image(c) for c in images]
            for meta, emb in zip(metas, self.clip.embed_image_batch(frames)):
                meta["clip_embedding"] = emb
            for i, image in enumerate(frames):
                metas[i]["width"] = int(image.shape[1])
                metas[i]["height"] = int(image.shape[0])
                texts[i] = f"image {image.shape[1]}x{image.shape[0]}"
        if self.llm is not None:
            for i, contents in enumerate(images):
                b64 = base64.b64encode(contents).decode()
                texts[i] = self.llm([{
                    "role": "user",
                    "content": [
                        {"type": "text", "text": self.prompt},
                        {"type": "image_url",
                         "image_url": {"url": f"data:image/png;base64,{b64}"}},
                    ],
                }])
        if self.clip is None and self.llm is None:
            raise ValueError(
                "ImageParser needs a clip_model (on-device) or llm "
                "(vision-chat) to parse images"
            )
        return list(zip(texts, metas))


class SlideParser(ImageParser):
    """Slide decks parse as per-page images (reference SlideParser).  PDF
    slides rasterize via pdf2image when installed; PPM page streams
    (concatenated P6 frames) split natively."""

    def _parse(self, contents):
        pages = self._split_pages(contents)
        return [(text, {**meta, "page": i})
                for i, (text, meta) in enumerate(self._parse_images(pages))]

    def _split_pages(self, contents: bytes) -> list[bytes]:
        if contents[:2] == b"P6":
            pages = []
            rest = contents
            while rest[:2] == b"P6":
                parts = rest.split(b"\n", 3)
                w, h = (int(x) for x in parts[1].split())
                n = w * h * 3
                header = b"\n".join(parts[:3]) + b"\n"
                pages.append(header + parts[3][:n])
                rest = parts[3][n:]
            return pages
        if contents[:5] == b"%PDF-":
            try:
                import io

                from pdf2image import convert_from_bytes
            except ImportError as exc:
                raise ImportError(
                    "PDF slide rasterization needs pdf2image"
                ) from exc
            pages = []
            for im in convert_from_bytes(contents):
                buf = io.BytesIO()
                im.save(buf, format="PNG")
                pages.append(buf.getvalue())
            return pages
        return [contents]


class PaddleOCRParser(ParserBase):
    """OCR parser (reference PaddleOCR wrapper, parsers.py:55-1170).

    Photographic/scene OCR uses the paddleocr package when installed;
    otherwise the native template-correlation engine (``_ocr.py``) reads
    machine-printed text (screenshots, rendered documents, terminal
    captures) with pillow as its one dependency."""

    def __init__(self, **kwargs):
        from ...internals.config import _check_entitlements

        _check_entitlements("advanced-parser")
        self.kwargs = kwargs
        self._paddle = None
        try:
            from paddleocr import PaddleOCR  # type: ignore
        except ImportError:
            pass  # the JAX package's documented fallback: the native engine
        else:
            self._paddle = PaddleOCR(**kwargs)

    def _parse(self, contents):
        if self._paddle is not None:
            result = self._paddle.ocr(contents)
            lines: list[str] = []
            for page in result or []:
                if page is None:
                    continue
                if isinstance(page, dict) or hasattr(page, "get"):
                    # paddleocr >= 3.x: dict-like OCRResult
                    lines.extend(page.get("rec_texts") or [])
                else:
                    # paddleocr 2.x: [[bbox, (text, confidence)], ...]
                    lines.extend(entry[1][0] for entry in page)
            return [("\n".join(lines), {"engine": "paddleocr"})]
        from ._ocr import ocr_image

        image = _decode_image(contents)
        return [(ocr_image(image), {"engine": "native-template"})]


def ParseUnstructured(**kwargs):  # noqa: N802
    """Legacy alias for UnstructuredParser (reference: parsers.py
    ParseUnstructured deprecation shim)."""
    return UnstructuredParser(**kwargs)


def default_vision_llm():
    """Default vision-capable chat for image/slide parsing (reference:
    parsers.py:46 — OpenAIChat on the default vision model with cache +
    backoff).  The on-device CLIP path (ImageParser) needs no LLM; this is
    the API-served alternative."""
    from ...internals.udfs import ExponentialBackoffRetryStrategy
    from .llms import OpenAIChat

    return OpenAIChat(
        model="gpt-4o-mini",
        retry_strategy=ExponentialBackoffRetryStrategy(max_retries=4),
    )


class AudioParser(ParserBase):
    """Transcribe audio via OpenAI's Whisper transcription endpoint
    (reference: parsers.py:1330).  Spoken as a plain multipart REST call
    with an injectable ``_http(url, body, headers)`` test seam; no client
    package needed.  A failed call raises."""

    def __init__(self, model: str = "whisper-1", *,
                 api_key: str | None = None,
                 base_url: str = "https://api.openai.com/v1",
                 filename: str | None = None, _http=None, **kwargs):
        self.model = model
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.base_url = base_url.rstrip("/")
        self.filename = filename  # None: sniffed from the magic bytes
        self._http = _http

    @staticmethod
    def _sniff_filename(contents: bytes) -> str:
        """The endpoint infers the audio format from the filename
        extension, so the part name must carry a real one."""
        if contents[:4] == b"RIFF":
            return "audio.wav"
        if contents[:4] == b"OggS":
            return "audio.ogg"
        if contents[:4] == b"fLaC":
            return "audio.flac"
        if contents[4:8] == b"ftyp":
            return "audio.m4a"
        return "audio.mp3"  # ID3 / MPEG frame sync, and anything else

    def _parse(self, contents: bytes):
        boundary = uuid.uuid4().hex
        fname = self.filename or self._sniff_filename(contents)
        parts = (
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="model"\r\n\r\n{self.model}\r\n'
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="file"; filename="{fname}"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n"
        ).encode() + contents + f"\r\n--{boundary}--\r\n".encode()
        headers = {
            "Authorization": f"Bearer {self.api_key}",
            "Content-Type": f"multipart/form-data; boundary={boundary}",
        }
        url = f"{self.base_url}/audio/transcriptions"
        if self._http is not None:  # test seam
            out = self._http(url, parts, headers)
        else:
            req = urllib.request.Request(url, data=parts, headers=headers,
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                out = json.loads(resp.read())
        return [(out.get("text", ""), {"model": self.model})]


class TwelveLabsVideoParser(ParserBase):
    """Describe videos via the TwelveLabs Pegasus REST API (reference:
    parsers.py:1399: upload asset -> wait ready -> generate text).  REST
    spoken directly with an injectable ``_http(method, url, payload,
    headers)`` seam.  A task that reports ``failed`` raises
    ``RuntimeError``, one not ready within ``max_wait_s``
    ``TimeoutError``."""

    def __init__(self, *, api_key: str | None = None, index_id: str = "",
                 prompt: str = "Describe this video in detail.",
                 base_url: str = "https://api.twelvelabs.io/v1.3",
                 poll_interval_s: float = 2.0, max_wait_s: float = 600.0,
                 _http=None, **kwargs):
        self.api_key = api_key or os.environ.get("TWELVE_LABS_API_KEY", "")
        self.index_id = index_id
        self.prompt = prompt
        self.base_url = base_url.rstrip("/")
        self.poll_interval_s = poll_interval_s
        self.max_wait_s = max_wait_s
        self._http = _http

    def _call(self, method: str, url: str, payload, headers):
        if self._http is not None:
            return self._http(method, url, payload, headers)
        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())

    def _parse(self, contents: bytes):
        headers = {"x-api-key": self.api_key,
                   "Content-Type": "application/json"}
        task = self._call(
            "POST", f"{self.base_url}/tasks",
            {"index_id": self.index_id,
             "video_base64": base64.b64encode(contents).decode()},
            headers,
        )
        task_id = task.get("_id") or task.get("id")
        video_id = task.get("video_id")
        deadline = time.monotonic() + self.max_wait_s
        while task.get("status") not in ("ready", "failed"):
            if time.monotonic() > deadline:
                raise TimeoutError("TwelveLabs task not ready in time")
            time.sleep(self.poll_interval_s)
            task = self._call("GET", f"{self.base_url}/tasks/{task_id}",
                              None, headers)
            video_id = task.get("video_id", video_id)
        if task.get("status") == "failed":
            raise RuntimeError(f"TwelveLabs task failed: {task}")
        gen = self._call(
            "POST", f"{self.base_url}/generate",
            {"video_id": video_id, "prompt": self.prompt}, headers,
        )
        text = gen.get("data", "") or gen.get("text", "")
        return [(text, {"video_id": video_id})]


__all__ = [
    "ParserBase", "Utf8Parser", "ParseUtf8", "PypdfParser",
    "UnstructuredParser", "ParseUnstructured", "DoclingParser",
    "ImageParser", "SlideParser", "PaddleOCRParser", "AudioParser",
    "TwelveLabsVideoParser", "default_vision_llm",
]
