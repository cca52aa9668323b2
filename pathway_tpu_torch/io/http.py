"""HTTP REST connector + webserver with OpenAPI documentation.

The serving half of ``pathway_tpu/io/http.py``: ``PathwayWebserver``
(``/_schema``, ``/debug/trace``, ``/debug/profile``, SSE streams),
``rest_connector`` and its ``raw_output`` lowering, and the HTTP client
connectors: ``read`` (a delimited streaming response as a live table,
with retries, reconnects that skip the messages already delivered, and
the trailing-buffer rules) and ``write`` (one POST an update row; a
failed POST fails the run).  The server starts when the engine starts
the connector's source and shuts down when the run stops it.

Reference: io/http/_server.py:388-723 — aiohttp server with per-endpoint
OpenAPI 3.0.3 schema generation served at ``/_schema``.  The server is
pure control-plane (it never touches device state), so a
thread-per-connection stdlib server with a bounded handler semaphore is
the right shape: requests block on the *engine's* commit cadence, not on
CPU.

`rest_connector` turns HTTP requests into a live query table; the returned
response writer delivers each query's first answer back to the waiting HTTP
client — the request/response idiom over the incremental engine
(SURVEY.md §3.5).

Concurrency model (a documented bound): each connection
gets an OS thread (``ThreadingHTTPServer``); at most ``max_concurrency``
handlers run their engine round-trip simultaneously — excess requests queue
on a semaphore and time out with 503 after ``queue_timeout_s``.
"""

from __future__ import annotations

import copy
import json
import logging
import threading
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Sequence
from urllib.parse import parse_qsl, urlsplit

from .. import obs
from ..serve.admission import EngineFailedError
from ..internals import dtype as dt
from ..internals import parse_graph as pg
from ..internals.datasource import SubjectDataSource
from ..internals.schema import SchemaMetaclass
from ..internals.table import Table
from ..internals.value import ref_scalar
from ..engine import operators as _ops
from ..engine.runner import register_lowering
from ..engine.types import unwrap_row
from ._utils import _jsonable, coerce_value, make_input_table

# Which column the payload binds to when the endpoint input format is 'raw'
# (reference: _server.py QUERY_SCHEMA_COLUMN)
QUERY_SCHEMA_COLUMN = "query"

# dtype -> OpenAPI type/format (reference: _ENGINE_TO_OPENAPI_TYPE/_FORMAT).
# 'any'/containers are omitted — they surface as additionalProperties.
_OPENAPI_TYPE = {
    dt.INT: "number",
    dt.STR: "string",
    dt.BOOL: "boolean",
    dt.FLOAT: "number",
    dt.POINTER: "string",
    dt.DATE_TIME_NAIVE: "string",
    dt.DATE_TIME_UTC: "string",
    dt.DURATION: "string",
    dt.BYTES: "bytes",
}
_OPENAPI_FORMAT = {dt.INT: "int64", dt.FLOAT: "double"}


def _strip_optional(d):
    return d.strip_optional() if hasattr(d, "strip_optional") else d


def _openapi_type_of(dtype):
    base = _strip_optional(dtype)
    if isinstance(base, dt.PointerDType):
        return "string", None
    return _OPENAPI_TYPE.get(base), _OPENAPI_FORMAT.get(base)


class EndpointExamples:
    """Named request examples embedded into the OpenAPI description
    (reference: _server.py EndpointExamples)."""

    def __init__(self):
        self.examples_by_id: dict[str, dict] = {}

    def add_example(self, id, summary, values) -> "EndpointExamples":  # noqa: A002
        if id in self.examples_by_id:
            raise ValueError(f"Duplicate example id: {id}")
        self.examples_by_id[id] = {"summary": summary, "value": values}
        return self

    def _openapi_description(self):
        return self.examples_by_id


class EndpointDocumentation:
    """Per-endpoint OpenAPI v3 documentation settings
    (reference: _server.py EndpointDocumentation).

    Args:
        summary: short description shown in the endpoint list.
        description: comprehensive endpoint description.
        tags: endpoint grouping tags.
        method_types: if set, only these methods are documented.
        examples: named request examples.
    """

    DEFAULT_RESPONSES = {
        "200": {"description": "OK"},
        "400": {
            "description": "The request is incorrect. Please check if it "
            "complies with the auto-generated and input table schemas"
        },
    }

    def __init__(
        self,
        *,
        summary: str | None = None,
        description: str | None = None,
        tags: Sequence[str] | None = None,
        method_types: Sequence[str] | None = None,
        examples: EndpointExamples | None = None,
    ):
        self.summary = summary
        self.description = description
        self.tags = tags
        self.method_types = (
            {m.upper() for m in method_types} if method_types is not None else None
        )
        self.examples = examples

    def _is_exposed(self, method: str) -> bool:
        return self.method_types is None or method.upper() in self.method_types

    def generate_docs(self, format: str, method: str, schema) -> dict:  # noqa: A002
        if not self._is_exposed(method):
            return {}
        if method.upper() == "GET":
            desc: dict[str, Any] = {
                "parameters": self._get_request_params(schema),
                "responses": copy.deepcopy(self.DEFAULT_RESPONSES),
            }
        else:
            if format == "raw":
                content = {"text/plain": {"schema": self._plaintext_schema(schema)}}
            else:
                content = {"application/json": {"schema": self._json_schema(schema)}}
            if self.examples:
                for media in content.values():
                    media["examples"] = self.examples._openapi_description()
            desc = {
                "requestBody": {"content": content},
                "responses": copy.deepcopy(self.DEFAULT_RESPONSES),
            }
        if self.tags is not None:
            desc["tags"] = list(self.tags)
        if self.description is not None:
            desc["description"] = self.description
        if self.summary is not None:
            desc["summary"] = self.summary
        return {method.lower(): desc}

    @staticmethod
    def _traits(field: dict, props) -> None:
        if getattr(props, "example", None) is not None:
            field["example"] = props.example
        if getattr(props, "description", None) is not None:
            field["description"] = props.description

    def _plaintext_schema(self, schema) -> dict:
        col = schema.columns().get(QUERY_SCHEMA_COLUMN)
        if col is None:
            raise ValueError(
                "'raw' endpoint input format requires a 'query' column in schema"
            )
        otype, ofmt = _openapi_type_of(col.dtype)
        desc = {"type": otype or "string"}
        if ofmt:
            desc["format"] = ofmt
        if col.has_default():
            desc["default"] = col.default_value
        self._traits(desc, col)
        return desc

    def _get_request_params(self, schema) -> list:
        params = []
        for name, props in schema.columns().items():
            field: dict[str, Any] = {
                "in": "query",
                "name": name,
                "required": not props.has_default(),
            }
            self._traits(field, props)
            otype, _ = _openapi_type_of(props.dtype)
            # untyped GET params would make the schema invalid -> string
            field["schema"] = {"type": otype or "string"}
            params.append(field)
        return params

    def _json_schema(self, schema) -> dict:
        properties: dict[str, Any] = {}
        required: list[str] = []
        additional = False
        for name, props in schema.columns().items():
            otype, ofmt = _openapi_type_of(props.dtype)
            if otype is None:
                additional = True  # JSON / arrays / Any: free-form
                continue
            field: dict[str, Any] = {"type": otype}
            if props.has_default():
                field["default"] = props.default_value
            else:
                required.append(name)
            self._traits(field, props)
            if ofmt is not None:
                field["format"] = ofmt
            properties[name] = field
        result: dict[str, Any] = {
            "type": "object",
            "properties": properties,
            "additionalProperties": additional,
        }
        if required:
            result["required"] = required
        return result


class _HttpError(Exception):
    def __init__(self, status: int, reason: str,
                 headers: dict[str, str] | None = None):
        self.status = status
        self.reason = reason
        self.headers = headers or {}
        super().__init__(reason)


class StreamingResponse:
    """Handler return sentinel: stream the response as Server-Sent
    Events with a per-event flush instead of one buffered body
    (token streaming).

    ``events`` is any iterable; a dict event is JSON-encoded, a str is
    sent verbatim — each as one ``data:`` frame, flushed immediately so
    the client sees every token as it lands.  The response STATUS is
    decided by the first event: an exception raised before it (a 429
    shed, a 503 engine failure) propagates to the normal error mappings
    with their Retry-After headers, because streaming only begins once
    there is something to send.  An exception after the first frame —
    the status line is already on the wire — emits a terminal
    ``event: error`` frame instead.  The stream always ends with a
    ``data: [DONE]`` frame on success."""

    def __init__(self, events, *, headers: dict[str, str] | None = None):
        self.events = events
        self.headers = headers or {}


_STREAM_END = object()


def _sse_frame(event) -> bytes:
    if isinstance(event, bytes):
        data = event.decode(errors="replace")
    elif isinstance(event, str):
        data = event
    else:
        data = json.dumps(event, default=str)
    return f"data: {data}\n\n".encode()


def _map_stream_error(exc: Exception) -> Exception:
    """Admission sheds raised inside a stream's submit worker map to the
    same 429 + Retry-After a non-streamed request gets."""
    from ..serve.admission import QueueFullError, ShedError

    if isinstance(exc, (QueueFullError, ShedError)):
        return _HttpError(
            429, str(exc),
            headers={"Retry-After": f"{max(1, round(exc.retry_after_s))}"},
        )
    return exc


class PathwayWebserver:
    """Shared HTTP endpoint host (reference: io/http PathwayWebserver).

    Args:
        host, port: bind address.
        with_schema_endpoint: serve the OpenAPI 3.0.3 description of every
            registered endpoint at ``/_schema`` (``?format=yaml|json``).
        with_cors: allow cross-origin requests.
        max_concurrency: documented concurrency bound — at most this many
            handler round-trips run at once; excess requests queue and get
            503 after ``queue_timeout_s``.
    """

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 8080,
        *,
        with_schema_endpoint: bool = True,
        with_cors: bool = False,
        max_concurrency: int = 64,
        queue_timeout_s: float = 30.0,
    ):
        self.host = host
        self.port = port
        self.with_cors = with_cors
        self._routes: dict[tuple[str, str], Any] = {}
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._sema = threading.BoundedSemaphore(max_concurrency)
        self._queue_timeout_s = queue_timeout_s
        self._openapi: dict[str, Any] = {
            "openapi": "3.0.3",
            "info": {
                "title": "pathway_tpu-generated openapi description",
                "version": "1.0.0",
            },
            "paths": {},
            "servers": [{"url": f"http://{host}:{port}/"}],
        }
        if with_schema_endpoint:
            self._routes[("GET", "/_schema")] = (self._schema_handler, True)
        # flight-recorder dump: Perfetto-loadable Chrome trace JSON of
        # recent spans (``?trace=<id>`` filters to one request's tree)
        self._routes[("GET", "/debug/trace")] = (self._trace_handler, True)
        # device cost observatory: the per-program
        # compile/FLOPs/dispatch/roofline table (?memory=1 adds
        # memory_analysis watermarks)
        self._routes[("GET", "/debug/profile")] = (
            self._profile_handler, True,
        )

    def _trace_handler(self, _payload: dict, meta: dict) -> Any:
        return _RawText(
            obs.chrome_trace_dump(meta.get("params")), "application/json"
        )

    def _profile_handler(self, _payload: dict, meta: dict) -> Any:
        from ..obs import profiler

        return _RawText(
            profiler.profile_dump(meta.get("params")), "application/json"
        )

    # -- OpenAPI -----------------------------------------------------------
    def openapi_description_json(self, origin: str | None = None) -> dict:
        result = copy.deepcopy(self._openapi)
        if origin:
            result["servers"] = [{"url": origin}]
        return result

    def openapi_description(self, origin: str | None = None) -> str:
        import yaml

        return yaml.dump(self.openapi_description_json(origin), sort_keys=False)

    def _schema_handler(self, payload: dict, meta: dict) -> Any:
        fmt = meta.get("params", {}).get("format", "yaml")
        origin = f"http://{meta.get('host') or f'{self.host}:{self.port}'}"
        if fmt == "json":
            return self.openapi_description_json(origin)
        if fmt != "yaml":
            raise _HttpError(
                400, f"Unknown format: '{fmt}'. Supported formats: 'json', 'yaml'"
            )
        return _RawText(self.openapi_description(origin), "text/x-yaml")

    # -- registration ------------------------------------------------------
    def register(
        self,
        route: str,
        methods: list[str],
        handler,
        *,
        schema=None,
        format: str = "custom",  # noqa: A002
        documentation: "EndpointDocumentation | None" = None,
    ) -> None:
        route = route.rstrip("/") or "/"
        docs = documentation or EndpointDocumentation()
        # handlers may take (payload) or (payload, meta) — probe the arity
        # once so legacy single-argument handlers keep working
        import inspect

        try:
            want_meta = len(inspect.signature(handler).parameters) >= 2
        except (TypeError, ValueError):
            want_meta = False
        endpoint_docs = {}
        for m in methods:
            self._routes[(m.upper(), route)] = (handler, want_meta)
            if schema is not None:
                endpoint_docs.update(docs.generate_docs(format, m, schema))
        if endpoint_docs:
            self._openapi["paths"].setdefault(route, {}).update(endpoint_docs)

    def register_stream(self, route: str, submit_fn, *,
                        methods: Sequence[str] = ("POST",),
                        timeout_s: float = 120.0) -> None:
        """Register an SSE token-streaming decode endpoint.

        ``submit_fn(prompt, max_new, *, on_token, ...)`` — typically
        :meth:`~pathway_tpu_torch.serve.fleet.ReplicaFleet.submit` — runs on a
        worker thread; every ``on_token`` callback flushes one
        ``data: {"token": ..., "index": ...}`` frame to the client, so
        the engine's TTFT is the user's time-to-first-frame.  The POST
        body is ``{"prompt": [ids...], "max_new": n}`` plus optional
        ``sampling`` (``[temperature, top_k, top_p, seed]`` or the dict
        form), ``session`` (KV tiering key) and ``priority`` —
        forwarded only if ``submit_fn`` accepts them.  The first frame
        echoes the request's ``X-Pathway-Trace`` id; a shed or
        engine-failure BEFORE the first token keeps the non-streamed
        429/503 + Retry-After mapping, one after it ends the stream
        with an ``event: error`` frame."""
        import inspect
        import queue as _queue

        try:
            accepted = set(inspect.signature(submit_fn).parameters)
        except (TypeError, ValueError):
            accepted = {"sampling", "session", "priority", "on_token"}

        def handler(payload: dict, meta: dict) -> StreamingResponse:
            prompt = payload.get("prompt")
            if not isinstance(prompt, list) or not prompt:
                raise _HttpError(
                    400, "`prompt` (non-empty list of token ids) is required"
                )
            try:
                prompt = [int(t) for t in prompt]
                max_new = int(payload.get("max_new", 16))
            except (TypeError, ValueError):
                raise _HttpError(400, "`prompt`/`max_new` must be integral")
            kwargs: dict[str, Any] = {}
            for key in ("sampling", "session"):
                if key in payload and key in accepted:
                    kwargs[key] = payload[key]
            hdr_priority = {
                str(k).lower(): v for k, v in meta.get("headers", {}).items()
            }.get("x-pathway-priority")
            priority = payload.get("priority", hdr_priority)
            if priority is not None and "priority" in accepted:
                from ..serve.admission import Priority

                try:
                    kwargs["priority"] = Priority.parse(priority)
                except ValueError:
                    raise _HttpError(400, f"bad priority: {priority!r}")

            q: "_queue.Queue[tuple[str, Any]]" = _queue.Queue()

            def work():
                try:
                    out = submit_fn(
                        prompt, max_new,
                        on_token=lambda t: q.put(("tok", t)), **kwargs,
                    )
                    q.put(("done", out))
                except Exception as exc:  # noqa: BLE001 - re-raised below
                    q.put(("err", exc))

            threading.Thread(
                target=work, daemon=True, name=f"sse{route}"
            ).start()

            def _get():
                try:
                    return q.get(timeout=timeout_s)
                except _queue.Empty:
                    raise TimeoutError(
                        f"stream stalled past {timeout_s}s"
                    ) from None

            def events():
                kind, val = _get()
                if kind == "err":
                    raise _map_stream_error(val)
                # first frame: the trace id, echoed ON the stream so a
                # client that only reads the body can still fetch
                # /debug/trace for this request
                yield {"trace": meta["trace_id"]}
                n = 0
                while True:
                    if kind == "tok":
                        yield {"token": int(val), "index": n}
                        n += 1
                    elif kind == "done":
                        yield {
                            "done": True,
                            "tokens": [int(t) for t in val],
                        }
                        return
                    else:
                        raise _map_stream_error(val)
                    kind, val = _get()

            return StreamingResponse(events())

        self.register(route, list(methods), handler)

    def _ensure_started(self) -> None:
        if self._server is not None:
            return
        ws = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _respond(self, code: int, payload: bytes, ctype="application/json",
                         extra_headers: dict | None = None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                for hk, hv in (extra_headers or {}).items():
                    self.send_header(hk, str(hv))
                if ws.with_cors:
                    self.send_header("Access-Control-Allow-Origin", "*")
                    self.send_header("Access-Control-Allow-Headers", "*")
                    self.send_header(
                        "Access-Control-Allow-Methods",
                        "GET, POST, PUT, PATCH, OPTIONS",
                    )
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _stream_sse(self, result: StreamingResponse, first, it,
                            access: dict, req_span, started: float):
                """Write an SSE response: headers (trace id echoed on
                the stream), one flushed ``data:`` frame per event, and
                a terminal ``[DONE]`` — or ``event: error`` if the
                source dies after the status line is on the wire."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("X-Pathway-Trace", req_span.trace_id)
                for hk, hv in result.headers.items():
                    self.send_header(hk, str(hv))
                if ws.with_cors:
                    self.send_header("Access-Control-Allow-Origin", "*")
                    self.send_header("Access-Control-Allow-Headers", "*")
                self.send_header("Connection", "close")
                self.end_headers()
                status = 200
                try:
                    if first is not _STREAM_END:
                        self.wfile.write(_sse_frame(first))
                        self.wfile.flush()
                        for event in it:
                            self.wfile.write(_sse_frame(event))
                            self.wfile.flush()
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except Exception as exc:
                    status = 500
                    err = {"error": str(exc), "trace": req_span.trace_id}
                    if isinstance(exc, _HttpError):
                        err["status"] = exc.status
                    if isinstance(exc, EngineFailedError):
                        err["retry_after_s"] = exc.retry_after_s
                    logging.error(json.dumps({
                        "_type": "stream_failed", **err,
                    }))
                    try:  # the client may already be gone: best-effort
                        self.wfile.write(b"event: error\n" + _sse_frame(err))
                        self.wfile.flush()
                    except Exception:
                        pass
                access["status"] = status
                access["time_elapsed"] = f"{time.time() - started:.3f}"
                (logging.info if status < 400 else logging.error)(
                    json.dumps(access)
                )
                req_span.finish(status=status)

            def _handle(self, method: str):
                session_id = "uuid-" + uuid.uuid4().hex
                started = time.time()
                split = urlsplit(self.path)
                path = split.path.rstrip("/") or "/"
                # request-scoped tracing: an X-Pathway-Trace
                # header joins the caller's trace, otherwise one is
                # minted here; the id is echoed back in the response so
                # clients can fetch the request's spans from /debug/trace
                req_span = obs.start_span(
                    "http.request",
                    ctx=obs.context_from_trace_header(
                        self.headers.get("X-Pathway-Trace")
                    ),
                    method=method, route=path,
                )
                access = {
                    "_type": "http_access",
                    "method": method,
                    "route": self.path,
                    "content_type": self.headers.get("Content-Type"),
                    "user_agent": self.headers.get("User-Agent"),
                    "unix_timestamp": int(started),
                    "remote": self.client_address[0],
                    "session_id": session_id,
                    "trace_id": req_span.trace_id,
                }

                def finish(code: int, payload: bytes, ctype="application/json",
                           extra_headers: dict | None = None):
                    access["status"] = code
                    access["time_elapsed"] = f"{time.time() - started:.3f}"
                    (logging.info if code < 400 else logging.error)(
                        json.dumps(access)
                    )
                    req_span.finish(status=code)
                    hdrs = dict(extra_headers or {})
                    hdrs.setdefault("X-Pathway-Trace", req_span.trace_id)
                    self._respond(code, payload, ctype, hdrs)

                entry = ws._routes.get((method, path))
                if entry is None:
                    finish(404, b'{"error": "no such route"}')
                    return
                handler, want_meta = entry
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                meta = {
                    "method": method,
                    "params": dict(parse_qsl(split.query)),
                    "headers": dict(self.headers.items()),
                    "host": self.headers.get("Host"),
                    "body": body,
                    "session_id": session_id,
                    "trace_id": req_span.trace_id,
                }
                if not ws._sema.acquire(timeout=ws._queue_timeout_s):
                    finish(503, b'{"error": "server at capacity"}')
                    return
                # spans opened by the handler (rest subject, scheduler
                # submit, engine) parent under this request's span
                _trace_token = obs.set_current(req_span.ctx)
                try:
                    # undecodable bodies become {} rather than a hard 400 —
                    # raw-format handlers consume meta['body'] verbatim and a
                    # custom-format handler will 400 on its missing required
                    # columns anyway (reference: RestServerSubject.handle)
                    try:
                        payload = json.loads(body) if body.strip() else {}
                        if not isinstance(payload, dict):
                            payload = {}
                    except json.JSONDecodeError:
                        payload = {}
                    result = handler(payload, meta) if want_meta else handler(payload)
                    if isinstance(result, StreamingResponse):
                        it = iter(result.events)
                        # pulling the first event BEFORE sending any
                        # header lets a pre-token failure (429 shed, 503
                        # engine-failed) propagate to the arms below and
                        # keep the exact non-streamed error mappings
                        try:
                            first = next(it)
                        except StopIteration:
                            first = _STREAM_END
                        self._stream_sse(result, first, it, access,
                                         req_span, started)
                    elif isinstance(result, _RawText):
                        finish(200, result.text.encode(), result.ctype)
                    else:
                        finish(200, json.dumps(result, default=str).encode())
                except _HttpError as he:
                    finish(he.status, json.dumps({"error": he.reason}).encode(),
                           extra_headers=he.headers)
                except EngineFailedError as ef:
                    # a request that died to an engine failure
                    # (or exhausted supervised restarts) is a TRANSIENT
                    # server-side outage — 503 + Retry-After with the
                    # trace id in the body, distinct from admission's
                    # 429 (the client did nothing wrong and should retry
                    # unchanged once the engine restarts/degrades)
                    logging.error(json.dumps({
                        "_type": "engine_failed",
                        "error": str(ef),
                        "trace_id": req_span.trace_id,
                        "engine_trace": ef.trace_id,
                        "dump_path": ef.dump_path,
                    }))
                    finish(
                        503,
                        json.dumps({
                            "error": str(ef),
                            "trace": req_span.trace_id,
                            "engine_trace": ef.trace_id,
                            "retry_after_s": ef.retry_after_s,
                        }).encode(),
                        extra_headers={
                            "Retry-After":
                                f"{max(1, round(ef.retry_after_s))}"
                        },
                    )
                except TimeoutError:
                    finish(504, b'{"error": "query timed out"}')
                except json.JSONDecodeError:
                    finish(400, b'{"error": "bad json"}')
                except Exception as exc:
                    logging.exception("Error in HTTP handler")
                    finish(500, json.dumps({"error": str(exc)}).encode())
                finally:
                    obs.reset_current(_trace_token)
                    ws._sema.release()

            def do_POST(self):
                self._handle("POST")

            def do_GET(self):
                self._handle("GET")

            def do_PUT(self):
                self._handle("PUT")

            def do_PATCH(self):
                self._handle("PATCH")

            def do_OPTIONS(self):
                self._respond(200, b"")

        self._server = _Server((self.host, self.port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class _Server(ThreadingHTTPServer):
    # a listen backlog for max_concurrency callers connecting at once
    # (socketserver's default of 5 drops the rest's SYNs into retries)
    request_queue_size = 128


class _RawText:
    def __init__(self, text: str, ctype: str):
        self.text = text
        self.ctype = ctype


class _RestSubject:
    """Bridges HTTP handler threads to the engine's query stream."""

    def __init__(self, schema: SchemaMetaclass, delete_completed_queries: bool,
                 timeout_s: float, format: str = "custom",  # noqa: A002
                 request_validator=None, admission_controller=None,
                 degrade_handler=None):
        self.schema = schema
        self.delete_completed = delete_completed_queries
        self.timeout_s = timeout_s
        self.format = format
        self.request_validator = request_validator
        self.admission = admission_controller
        self.degrade_handler = degrade_handler
        self.pending: dict[int, tuple[threading.Event, list]] = {}
        self._source: SubjectDataSource | None = None
        self._started = threading.Event()
        self._stopped = threading.Event()

    def _run(self, source: SubjectDataSource) -> None:
        self._source = source
        self._started.set()
        # stay alive until the engine stops the source
        self._stopped.wait()

    def _build_payload(self, payload: dict, meta: dict) -> dict:
        if self.format == "raw":
            return {QUERY_SCHEMA_COLUMN: meta["body"].decode(errors="replace")}
        # custom: JSON body, query params fill the gaps (GET requests
        # deliver everything via params) — reference: RestServerSubject.handle
        merged = dict(payload) if isinstance(payload, dict) else {}
        for k, v in meta.get("params", {}).items():
            merged.setdefault(k, v)
        return merged

    def _verify_payload(self, payload: dict) -> None:
        for name, props in self.schema.columns().items():
            if name not in payload and not props.has_default():
                raise _HttpError(400, f"`{name}` is required")

    def _admit(self, payload: dict, meta: dict):
        """Admission gate (serve/admission.py): returns a degrade response
        wrapped in _RawText/value or None when admitted; raises _HttpError
        429 (+ Retry-After) when the request is shed."""
        if self.admission is None:
            return None
        from ..serve.admission import Priority, QueueFullError, ShedError

        headers = {str(k).lower(): v for k, v in meta.get("headers", {}).items()}
        try:
            priority = Priority.parse(
                headers.get("x-pathway-priority", Priority.NORMAL)
            )
        except ValueError:
            priority = Priority.NORMAL
        try:
            self.admission.try_acquire(
                priority, will_degrade=self.degrade_handler is not None
            )
        except QueueFullError as exc:
            if self.degrade_handler is not None:
                # degrade-to-cheaper-tier: answer without entering the
                # engine queue at all
                self.admission.record_degraded()
                return (self.degrade_handler(payload, meta),)
            raise _HttpError(
                429, str(exc),
                headers={"Retry-After": f"{max(1, round(exc.retry_after_s))}"},
            )
        except ShedError as exc:
            raise _HttpError(
                429, str(exc),
                headers={"Retry-After": f"{max(1, round(exc.retry_after_s))}"},
            )
        return None

    def handle(self, payload: dict, meta: dict | None = None) -> Any:
        meta = meta or {"params": {}, "headers": {}, "body": b""}
        with obs.span("rest.handle", format=self.format):
            return self._handle_traced(payload, meta)

    def _handle_traced(self, payload: dict, meta: dict) -> Any:
        payload = self._build_payload(payload, meta)
        self._verify_payload(payload)
        if self.request_validator is not None:
            try:
                ret = self.request_validator(payload, meta.get("headers", {}))
                if ret is not None:
                    raise ValueError(ret)
            except _HttpError:
                raise
            except Exception as exc:
                logging.error(json.dumps({
                    "_type": "validator_rejected_http_request",
                    "error": str(exc),
                }))
                raise _HttpError(400, str(exc))
        degraded = self._admit(payload, meta)
        if degraded is not None:
            return degraded[0]
        ok = False
        try:
            self._started.wait(timeout=10)
            colnames = self.schema.column_names()
            dtypes = self.schema.dtypes()
            defaults = {
                n: p.default_value
                for n, p in self.schema.columns().items()
                if p.has_default()
            }
            qid = ref_scalar("rest", uuid.uuid4().hex)
            row = tuple(
                coerce_value(payload.get(c, defaults.get(c)), dtypes[c])
                for c in colnames
            )
            ev = threading.Event()
            slot: list = []
            self.pending[qid] = (ev, slot)
            self._source.push(row, 1, qid)
            # the engine round-trip: push -> dataflow -> response writer
            with obs.span("rest.engine_wait"):
                ok = ev.wait(timeout=self.timeout_s)
            if self.delete_completed:
                self._source.push(row, -1, qid)
            self.pending.pop(qid, None)
            if not ok:
                raise TimeoutError
            return slot[0] if slot else None
        finally:
            if self.admission is not None:
                self.admission.release(completed=ok)

    def deliver(self, key: int, value: Any) -> None:
        entry = self.pending.get(key)
        if entry is not None:
            ev, slot = entry
            slot.clear()
            slot.append(value)
            ev.set()



class _RestSource(SubjectDataSource):
    """A REST endpoint's query stream: starting it starts the shared
    webserver (once), stopping it ends the subject's thread and shuts
    the webserver down."""

    def __init__(self, subject: "_RestSubject", webserver: PathwayWebserver,
                 colnames: list[str]):
        super().__init__(subject, colnames, None, append_only=False)
        self.webserver = webserver

    def start(self) -> None:
        self.webserver._ensure_started()
        super().start()

    def stop(self) -> None:
        super().stop()
        self.subject._stopped.set()
        self.webserver.shutdown()


class RetryPolicy:
    """Delay policy for stream-read retries (reference: io/http
    RetryPolicy)."""

    def __init__(self, first_delay_ms: int = 1000, backoff_factor: float = 2.0,
                 jitter_ms: int = 0):
        self.first_delay_ms = first_delay_ms
        self.backoff_factor = backoff_factor
        self.jitter_ms = jitter_ms

    @classmethod
    def default(cls) -> "RetryPolicy":
        return cls()

    def delay_s(self, attempt: int) -> float:
        import random

        base = self.first_delay_ms * (self.backoff_factor ** attempt)
        return (base + random.uniform(0, self.jitter_ms)) / 1000.0


def read(
    url: str,
    *,
    schema: SchemaMetaclass | None = None,
    method: str = "GET",
    payload: Any | None = None,
    headers: dict[str, str] | None = None,
    response_mapper=None,
    format: str = "json",  # noqa: A002
    delimiter: str | bytes | None = None,
    n_retries: int = 0,
    retry_policy: RetryPolicy | None = None,
    connect_timeout_ms: int | None = None,
    request_timeout_ms: int | None = None,
    allow_redirects: bool = True,
    retry_codes: tuple | None = (429, 500, 502, 503, 504),
    autocommit_duration_ms: int = 10000,
    flush_trailing: bool = False,
    deterministic_rerun: bool = False,
    **kwargs,
):
    """Read a table from a streaming HTTP endpoint (reference: io/http
    read).  The response body splits into messages on `delimiter`
    (default newline); "json" format parses each message into schema
    columns, "raw" binds it to a single `data` column.

    `flush_trailing`: deliver a final message that was not terminated by
    `delimiter` when the stream ends.  Off by default — for endpoints
    without Content-Length (chunked streaming, the usual case) a dropped
    connection is indistinguishable from a clean EOF, and flushing would
    emit the truncated tail as a complete record and end the stream; with
    the flag off such an EOF retries like any other disconnect.  Responses WITH Content-Length verify completeness directly, so
    their delimiter-less tail is always delivered.  With ``n_retries >= 2``
    an IDENTICAL trailing buffer re-read on 3 consecutive attempts is
    recognized as a stable tail from a well-behaved endpoint and delivered
    as the final record — a dropped connection would re-read a
    different or growing stream; with fewer retries only the distinct
    mid-message log line fires.

    `deterministic_rerun`: under persistence, whether a process restart
    re-delivers the same byte stream from the start.  Kept as a flag; this
    package has no persistence, so it has no effect (as in the JAX
    package without a persistence config).

    A read that fails past its retries raises on the source's thread and
    ends the stream there; the run goes on with the rows delivered, as in
    the JAX package."""
    from ..internals.schema import schema_from_types
    from . import python as io_python

    if format == "raw":
        if schema is not None:
            raise ValueError(
                "format='raw' produces a single `data` column; a custom "
                "schema cannot be honored — drop one of the two"
            )
        schema = schema_from_types(data=bytes)
    elif schema is None:
        schema = schema_from_types(data=str)
    delim = delimiter if delimiter is not None else b"\n"
    if isinstance(delim, str):
        delim = delim.encode()
    policy = retry_policy or RetryPolicy.default()

    _det_rerun = deterministic_rerun

    class _HttpStreamSubject(io_python.ConnectorSubject):
        deterministic_rerun = _det_rerun

        def run(self) -> None:
            import http.client as _http_client
            import urllib.error
            import urllib.request

            attempt = 0
            delivered = 0  # survives reconnects: re-read msgs are skipped
            last_tail: bytes | None = None  # trailing buffer of prior attempt
            tail_stable = 0  # consecutive attempts ending in the SAME tail
            while True:
                hdrs = dict(headers or {})
                if payload is not None and not any(
                    h.lower() == "content-type" for h in hdrs
                ):
                    hdrs["Content-Type"] = "application/json"
                req = urllib.request.Request(
                    url,
                    data=(json.dumps(payload).encode()
                          if payload is not None else None),
                    headers=hdrs, method=method,
                )
                try:
                    connect_s = (connect_timeout_ms or 0) / 1000 or None
                    # whole-request wall-clock cap, enforced between chunks
                    # (urllib has no separate read-phase timeout)
                    deadline = (
                        time.monotonic() + request_timeout_ms / 1000
                        if request_timeout_ms else None
                    )
                    opener = urllib.request.build_opener() if allow_redirects \
                        else urllib.request.build_opener(_NoRedirect())
                    seen = 0
                    with opener.open(req, timeout=connect_s) as resp:
                        expected = resp.headers.get("Content-Length")
                        expected = int(expected) if expected else None
                        received = 0
                        buf = bytearray()
                        while True:
                            if deadline is not None and \
                                    time.monotonic() > deadline:
                                raise TimeoutError(
                                    f"http.read exceeded request timeout "
                                    f"{request_timeout_ms}ms"
                                )
                            chunk = resp.read(8192)
                            if not chunk:
                                if expected is not None and received < expected:
                                    # premature close: http.client returns
                                    # EOF instead of raising — surface it so
                                    # the retry path resumes the stream
                                    raise OSError(
                                        f"connection closed after {received}"
                                        f"/{expected} bytes"
                                    )
                                break
                            received += len(chunk)
                            buf.extend(chunk)
                            # consume complete messages; one prefix-del per
                            # chunk keeps this linear in stream size
                            start = 0
                            while True:
                                pos = buf.find(delim, start)
                                if pos < 0:
                                    break
                                seen += 1
                                if seen > delivered:
                                    self._deliver(bytes(buf[start:pos]))
                                    delivered = seen
                                    # fresh data flowed: this connection is
                                    # healthy, so earlier transport errors
                                    # stop counting against the retry
                                    # budget (and against the stable-tail
                                    # attempts a trailing record needs)
                                    attempt = 0
                                start = pos + len(delim)
                            if start:
                                del buf[:start]
                        if bytes(buf).strip():
                            # a delimiter-less tail at EOF: for a stream
                            # with verified Content-Length it is the last
                            # message; without one, a mid-message drop
                            # looks identical to clean EOF, so treat it as
                            # a retryable disconnect unless the caller
                            # opted into flushing
                            if expected is None and not flush_trailing:
                                tail = bytes(buf)
                                if tail == last_tail:
                                    tail_stable += 1
                                else:
                                    last_tail, tail_stable = tail, 1
                                if tail_stable >= 3:
                                    # the SAME unterminated tail came back
                                    # on 3 consecutive attempts: a dropped
                                    # connection would re-read a different
                                    # (or growing) stream, so this is a
                                    # well-behaved endpoint whose final
                                    # record simply lacks the delimiter —
                                    # deliver it instead of burning the
                                    # rest of the retry budget
                                    logging.getLogger(__name__).warning(
                                        "http.read %s: identical %d-byte "
                                        "trailing buffer across %d "
                                        "consecutive attempts; delivering "
                                        "it as the final record",
                                        url, len(tail), tail_stable,
                                    )
                                    seen += 1
                                    if seen > delivered:
                                        self._deliver(tail)
                                        delivered = seen
                                else:
                                    logging.getLogger(__name__).info(
                                        "http.read %s: connection ended "
                                        "mid-message (no Content-Length, "
                                        "%d-byte trailing buffer, seen "
                                        "%dx); retrying",
                                        url, len(buf), tail_stable,
                                    )
                                    raise OSError(
                                        "connection ended mid-message (no "
                                        "Content-Length, trailing partial "
                                        "buffer); pass flush_trailing=True "
                                        "to deliver unterminated tails "
                                        "instead"
                                    )
                            else:
                                seen += 1
                                if seen > delivered:
                                    self._deliver(bytes(buf))
                                    delivered = seen
                    return  # stream finished cleanly
                except urllib.error.HTTPError as exc:
                    if (retry_codes and exc.code in retry_codes
                            and attempt < n_retries):
                        time.sleep(policy.delay_s(attempt))
                        attempt += 1
                        continue
                    raise
                except (OSError, TimeoutError, _http_client.HTTPException):
                    if attempt < n_retries:
                        time.sleep(policy.delay_s(attempt))
                        attempt += 1
                        continue
                    raise

        def _deliver(self, msg: bytes) -> None:
            if response_mapper is not None:
                msg = response_mapper(msg)
            if format == "raw":
                self.next_bytes(msg)
            else:
                self.next_json(json.loads(msg))

    return io_python.read(
        _HttpStreamSubject(), schema=schema,
        autocommit_duration_ms=autocommit_duration_ms,
        name=f"http:{url}",
    )


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):
        return None


def rest_connector(
    host: str = "0.0.0.0",
    port: int = 8080,
    *,
    route: str = "/",
    schema: SchemaMetaclass | None = None,
    methods: list[str] | None = None,
    format: str = "custom",  # noqa: A002
    autocommit_duration_ms: int = 50,
    keep_queries: bool = False,
    delete_completed_queries: bool = True,
    request_validator=None,
    webserver: PathwayWebserver | None = None,
    timeout_s: float = 30.0,
    documentation: EndpointDocumentation | None = None,
    admission_controller=None,
    degrade_handler=None,
):
    """Expose an HTTP endpoint as a live query table.

    Returns ``(queries_table, response_writer)``; each request blocks until
    the engine's answer for its row reaches the response writer.  The
    endpoint's request schema is published in OpenAPI form at ``/_schema``
    (reference: io/http/_server.py rest_connector).

    ``admission_controller`` (serve/admission.py AdmissionController) bounds
    how many requests may be pending in the engine at once and rate-limits
    per priority class (header ``X-Pathway-Priority: high|normal|low``);
    shed requests get ``429`` with a ``Retry-After`` header instead of
    queueing unboundedly.  With ``degrade_handler`` set, over-capacity
    requests are answered by ``degrade_handler(payload, meta)`` (a cheaper
    tier) instead of being shed.
    """
    if keep_queries:
        # reference alias: keep_queries=True retains query rows (the
        # inverse of delete_completed_queries)
        delete_completed_queries = False
    if schema is None:
        from ..internals.schema import schema_from_types

        schema = schema_from_types(query=str)
    if format == "raw" and QUERY_SCHEMA_COLUMN not in schema.column_names():
        raise ValueError(
            "'raw' endpoint input format requires a 'query' column in schema"
        )
    ws = webserver or PathwayWebserver(host, port)
    subject = _RestSubject(
        schema, delete_completed_queries, timeout_s, format=format,
        request_validator=request_validator,
        admission_controller=admission_controller,
        degrade_handler=degrade_handler,
    )
    ws.register(
        route, methods or ["POST"], subject.handle,
        schema=schema, format=format,
        documentation=documentation,
    )

    colnames = schema.column_names()
    source = _RestSource(subject, ws, colnames)
    queries = make_input_table(schema, source, name=f"rest:{route}")

    def response_writer(response_table: Table, result_column: str | None = None) -> None:
        rcols = response_table.column_names()
        col = result_column or ("result" if "result" in rcols else rcols[0])
        pos = rcols.index(col)

        def on_time(time: int, updates: list) -> None:
            for key, row, diff in updates:
                if diff > 0:
                    subject.deliver(key, _jsonable(unwrap_row(row)[pos]))

        pg.new_output_node(
            "raw_output", [response_table], on_time=on_time, colnames=rcols
        )

    return queries, response_writer


@register_lowering("raw_output")
def _lower_raw_output(node, lg):
    return _ops.OutputOperator(node.params["on_time"], name="raw_output")



def write(table: Table, url: str, *, method: str = "POST",
          format: str = "json", **kwargs) -> None:  # noqa: A002
    """POST each update row to ``url`` as one JSON object: the row's
    columns plus ``time`` and ``diff`` (reference: io/http write).  A POST
    that fails (no answer, or an HTTP error status) fails the run: no
    output row is lost without a trace."""
    colnames = table.column_names()

    def on_time(time: int, updates: list) -> None:
        for key, row, diff in updates:
            obj = dict(zip(colnames, [_jsonable(v) for v in unwrap_row(row)]))
            obj.update(time=time, diff=diff)
            req = urllib.request.Request(
                url, json.dumps(obj, default=str).encode(),
                headers={"Content-Type": "application/json"}, method=method,
            )
            with urllib.request.urlopen(req, timeout=10):
                pass

    pg.new_output_node("raw_output", [table], on_time=on_time,
                       colnames=colnames)
