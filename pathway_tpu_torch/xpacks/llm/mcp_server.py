"""MCP server exposing DocumentStore / RAG tools (the port of
``pathway_tpu/xpacks/llm/mcp_server.py``; reference:
xpacks/llm/mcp_server.py:168,308 via fastmcp).

Implements MCP's streamable-HTTP JSON-RPC surface (``initialize``,
``tools/list``, ``tools/call``) directly on the port's
``PathwayWebserver``, with no fastmcp dependency.  ``McpServer.run``
starts the webserver, runs ``pw.run`` with its keyword arguments and
shuts the webserver down when the run ends.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable

from ...io.http import PathwayWebserver


@dataclasses.dataclass
class McpConfig:
    name: str = "pathway-tpu-mcp"
    host: str = "0.0.0.0"
    port: int = 8123
    transport: str = "streamable-http"


class McpServable:
    def register_mcp(self, server: "McpServer") -> None:
        raise NotImplementedError


class McpServer:
    _instances: dict[tuple[str, int], "McpServer"] = {}

    def __init__(self, config: McpConfig):
        from ...internals.config import _check_entitlements

        _check_entitlements("xpack-llm-mcp")
        self.config = config
        self.tools: dict[str, tuple[Callable, dict]] = {}
        self.webserver = PathwayWebserver(config.host, config.port)
        self.webserver.register("/mcp", ["POST"], self._handle)

    @classmethod
    def get(cls, config: McpConfig) -> "McpServer":
        key = (config.host, config.port)
        if key not in cls._instances:
            cls._instances[key] = cls(config)
        return cls._instances[key]

    def tool(self, name: str, *, request_handler: Callable,
             schema: Any = None) -> None:
        self.tools[name] = (request_handler, _schema_to_json(schema))

    def _handle(self, payload: dict) -> dict:
        method = payload.get("method")
        msg_id = payload.get("id")

        def ok(result):
            return {"jsonrpc": "2.0", "id": msg_id, "result": result}

        if method == "initialize":
            return ok(
                {
                    "protocolVersion": "2024-11-05",
                    "serverInfo": {"name": self.config.name, "version": "0.1"},
                    "capabilities": {"tools": {}},
                }
            )
        if method == "tools/list":
            return ok(
                {
                    "tools": [
                        {"name": n, "inputSchema": s or {"type": "object"}}
                        for n, (_h, s) in self.tools.items()
                    ]
                }
            )
        if method == "tools/call":
            params = payload.get("params", {})
            name = params.get("name")
            if name not in self.tools:
                return {"jsonrpc": "2.0", "id": msg_id,
                        "error": {"code": -32601, "message": f"no tool {name}"}}
            handler, _ = self.tools[name]
            result = handler(params.get("arguments", {}))
            return ok({"content": [{"type": "text",
                                    "text": json.dumps(result, default=str)}]})
        return {"jsonrpc": "2.0", "id": msg_id,
                "error": {"code": -32601, "message": f"unknown method {method}"}}

    def run(self, **kwargs):
        from ... import run

        self.webserver._ensure_started()
        try:
            run(**kwargs)
        finally:
            self.webserver.shutdown()


def _schema_to_json(schema) -> dict | None:
    """A pathway schema's columns as a JSON schema of strings; None when
    there is no schema, or the object has no ``column_names``."""
    if schema is None:
        return None
    column_names = getattr(schema, "column_names", None)
    if column_names is None:
        return None
    props = {n: {"type": "string"} for n in column_names()}
    return {"type": "object", "properties": props}


class PathwayMcp:
    """Declarative MCP app: serve multiple servables (reference API)."""

    def __init__(self, name: str = "pathway-tpu-mcp", host: str = "0.0.0.0",
                 port: int = 8123, transport: str = "streamable-http",
                 serve: list[McpServable] | None = None):
        self.config = McpConfig(name, host, port, transport)
        self.server = McpServer.get(self.config)
        for s in serve or []:
            s.register_mcp(self.server)

    def run(self, **kwargs):
        self.server.run(**kwargs)
