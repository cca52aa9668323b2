"""Airbyte connector runtime: run any Airbyte source and stream its records.

Reference: python/pathway/io/airbyte/__init__.py:47 (read) +
python/pathway/io/airbyte/logic.py (_PathwayAirbyteSubject/Destination) +
third_party/airbyte_serverless (vendored serverless runner).  Re-designed
here around one seam — a connector COMMAND speaking the Airbyte stdout
protocol (`spec` / `check` / `discover` / `read` emitting JSON lines with
RECORD / STATE / CATALOG / LOG messages) — with three launchers:

  - ExecutableAirbyteSource: any argv (tests use a local fake script;
    production can point at an installed `airbyte-source-*` entrypoint)
  - VenvAirbyteSource: pip-install `airbyte-<connector>` into a private
    venv and run its console script (network required, like the reference's
    PyPI method)
  - DockerAirbyteSource: `docker run -i airbyte/<connector>`

Incremental sync carries the connector's STATE messages as the offset
frontier: they persist through the engine's offset machinery (get_offsets /
seek), so a restart resumes the Airbyte stream exactly where it left off.

The port of ``pathway_tpu/io/airbyte.py``.  A persisted state that does not
parse as JSON raises at ``seek``, where the JAX module drops it and
re-syncs from the start: the journal holds only states this module wrote.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
from typing import Any, Sequence

from ..internals import dtype as dt
from ..internals.compat import schema_builder
from ..internals.schema import ColumnDefinition
from ._utils import make_input_table

FULL_REFRESH_SYNC_MODE = "full_refresh"
INCREMENTAL_SYNC_MODE = "incremental"


class AirbyteError(RuntimeError):
    pass


class AbstractAirbyteSource:
    """Launches a connector command and speaks the Airbyte protocol."""

    def __init__(self, config: dict | None, streams: Sequence[str],
                 env_vars: dict[str, str] | None = None):
        self.config = config or {}
        self.streams = list(streams)
        self.env_vars = dict(env_vars or {})
        self._catalog: dict | None = None

    # -- launcher seam ------------------------------------------------------
    def command(self) -> list[str]:
        raise NotImplementedError

    def _run(self, args: list[str], files: dict[str, Any]) -> list[dict]:
        """Run `command() + args` with each value in `files` materialized as
        a temp JSON file appended as `--<flag> <path>`; parse protocol lines."""
        out: list[dict] = []
        for msg in self._stream(args, files):
            out.append(msg)
        return out

    def _stream(self, args: list[str], files: dict[str, Any]):
        env = dict(os.environ)
        env.update(self.env_vars)
        with tempfile.TemporaryDirectory(prefix="pw_airbyte_") as tmp:
            argv = list(self.command()) + list(args)
            for flag, payload in files.items():
                path = os.path.join(tmp, f"{flag}.json")
                with open(path, "w") as f:
                    json.dump(payload, f)
                argv += [f"--{flag}", path]
            proc = subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                env=env, text=True,
            )
            try:
                assert proc.stdout is not None
                for line in proc.stdout:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        msg = json.loads(line)
                    except ValueError:
                        continue  # connectors may log plain text lines
                    if msg.get("type") == "TRACE":
                        err = msg.get("trace", {}).get("error", {})
                        if err:
                            raise AirbyteError(
                                err.get("message", "connector error")
                            )
                    yield msg
            finally:
                proc.wait()
                if proc.returncode not in (0, None):
                    stderr = (proc.stderr.read() if proc.stderr else "")[-2000:]
                    raise AirbyteError(
                        f"airbyte connector exited with {proc.returncode}: "
                        f"{stderr}"
                    )

    # -- protocol verbs -----------------------------------------------------
    def check(self) -> None:
        for msg in self._run(["check"], {"config": self.config}):
            if msg.get("type") == "CONNECTION_STATUS":
                status = msg["connectionStatus"]
                if status.get("status") != "SUCCEEDED":
                    raise AirbyteError(
                        f"connection check failed: {status.get('message')}"
                    )
                return
        raise AirbyteError("connector emitted no CONNECTION_STATUS")

    def discover(self) -> dict:
        for msg in self._run(["discover"], {"config": self.config}):
            if msg.get("type") == "CATALOG":
                return msg["catalog"]
        raise AirbyteError("connector emitted no CATALOG")

    @property
    def configured_catalog(self) -> dict:
        if self._catalog is None:
            catalog = self.discover()
            available = {s["name"]: s for s in catalog.get("streams", [])}
            missing = [s for s in self.streams if s not in available]
            if missing:
                raise AirbyteError(
                    f"streams {missing} not found; connector offers "
                    f"{sorted(available)}"
                )
            selected = self.streams or sorted(available)
            conf = []
            for name in selected:
                stream = available[name]
                modes = stream.get("supported_sync_modes", [FULL_REFRESH_SYNC_MODE])
                sync = (
                    INCREMENTAL_SYNC_MODE
                    if INCREMENTAL_SYNC_MODE in modes
                    else FULL_REFRESH_SYNC_MODE
                )
                conf.append({
                    "stream": stream,
                    "sync_mode": sync,
                    "destination_sync_mode": "append",
                })
            self._catalog = {"streams": conf}
        return self._catalog

    def extract(self, state: list | None = None):
        """Yield RECORD / STATE messages for the configured streams."""
        files = {
            "config": self.config,
            "catalog": self.configured_catalog,
        }
        if state:
            files["state"] = state
        for msg in self._stream(["read"], files):
            if msg.get("type") in ("RECORD", "STATE"):
                yield msg


class ExecutableAirbyteSource(AbstractAirbyteSource):
    """The seam: any argv implementing the Airbyte protocol."""

    def __init__(self, command: Sequence[str] | str, config: dict | None = None,
                 streams: Sequence[str] = (), env_vars=None):
        super().__init__(config, streams, env_vars)
        self._command = (
            command.split() if isinstance(command, str) else list(command)
        )

    def command(self) -> list[str]:
        return self._command


class VenvAirbyteSource(AbstractAirbyteSource):
    """pip-install airbyte-<connector> into a private venv (PyPI method)."""

    def __init__(self, connector: str, config=None, streams=(), env_vars=None,
                 dependency_overrides: Sequence[str] | None = None,
                 venv_root: str | None = None):
        super().__init__(config, streams, env_vars)
        self.connector = connector.removeprefix("airbyte/").partition(":")[0]
        self.dependency_overrides = list(dependency_overrides or [])
        self.venv_root = venv_root or os.path.join(
            tempfile.gettempdir(), "pw_airbyte_venvs"
        )
        self._entry: str | None = None

    def command(self) -> list[str]:
        if self._entry is None:
            import sys
            import venv as _venv

            vdir = os.path.join(self.venv_root, self.connector)
            entry = os.path.join(vdir, "bin", self.connector)
            if not os.path.exists(entry):
                _venv.create(vdir, with_pip=True)
                pkgs = [f"airbyte-{self.connector}"] + self.dependency_overrides
                res = subprocess.run(
                    [os.path.join(vdir, "bin", "pip"), "install", *pkgs],
                    capture_output=True, text=True,
                )
                if res.returncode != 0:
                    raise AirbyteError(
                        f"pip install airbyte-{self.connector} failed "
                        f"(offline?): {res.stderr[-500:]}"
                    )
            self._entry = entry
        return [self._entry]


class DockerAirbyteSource(AbstractAirbyteSource):
    """docker run -i airbyte/<connector> (the reference's docker method)."""

    def __init__(self, connector: str, config=None, streams=(), env_vars=None):
        super().__init__(config, streams, env_vars)
        self.image = connector if "/" in connector else f"airbyte/{connector}"

    def command(self) -> list[str]:
        # config/catalog/state temp files are mounted via the shared tmp dir
        return [
            "docker", "run", "--rm", "-i",
            "-v", f"{tempfile.gettempdir()}:{tempfile.gettempdir()}",
            self.image,
        ]


def _record_key(stream: str, data: dict) -> str:
    from ..internals.value import hash_values

    return f"{stream}:{hash_values((stream, json.dumps(data, sort_keys=True, default=str)))}"


class _AirbyteSubject:
    """ConnectorSubject bridging an AbstractAirbyteSource into the engine.

    Incremental streams: records append, STATE messages advance the offset
    frontier.  Full-refresh streams in streaming mode: each poll re-extracts
    and the subject diffs against the previous snapshot, emitting inserts
    and retractions (the reference re-syncs on refresh_interval)."""

    def __init__(self, source: AbstractAirbyteSource, mode: str,
                 refresh_interval_s: float):
        self.source = source
        self.mode = mode
        self.refresh_interval_s = refresh_interval_s
        self.state: list = []
        self._snapshot: dict[str, dict] = {}
        self._stop = False
        self._colnames = ["stream", "data"]
        self._dtypes = {"stream": dt.STR, "data": dt.JSON}

    # offsets: the Airbyte state blob IS the resume frontier
    def get_offsets(self) -> dict:
        return {"airbyte_state": json.dumps(self.state)}

    def seek(self, offsets: dict) -> None:
        blob = offsets.get("airbyte_state")
        if blob:
            self.state = json.loads(blob)

    def _sync_modes(self) -> dict[str, str]:
        return {
            s["stream"]["name"]: s["sync_mode"]
            for s in self.source.configured_catalog["streams"]
        }

    def _apply_state(self, msg: dict) -> None:
        state = msg.get("state", {})
        if state.get("type") == "STREAM":
            descr = state["stream"]["stream_descriptor"]["name"]
            self.state = [
                s for s in self.state
                if not (
                    s.get("type") == "STREAM"
                    and s["stream"]["stream_descriptor"]["name"] == descr
                )
            ] + [state]
        elif state.get("type") == "GLOBAL":
            self.state = [state]
        else:  # legacy whole-connector state
            self.state = [{"type": "LEGACY", "data": state.get("data", state)}]

    def _run(self, source_handle) -> None:
        import time as _time

        from ..internals.value import Json

        push = source_handle.push
        modes = self._sync_modes()
        while not self._stop:
            seen: dict[str, dict] = {}
            for msg in self.source.extract(self.state):
                if msg.get("type") == "STATE":
                    self._apply_state(msg)
                    continue
                rec = msg["record"]
                stream = rec.get("stream", "")
                data = rec.get("data", {})
                if modes.get(stream) == FULL_REFRESH_SYNC_MODE:
                    key = _record_key(stream, data)
                    seen[key] = {"stream": stream, "data": data}
                    if key not in self._snapshot:
                        push((stream, Json(data)), 1, key)
                else:
                    push((stream, Json(data)), 1, None)
            # full-refresh diff: rows absent from this sync retract
            for key, row in list(self._snapshot.items()):
                if key not in seen:
                    push((row["stream"], Json(row["data"])), -1, key)
            self._snapshot = seen
            if self.mode == "static":
                break
            deadline = _time.monotonic() + self.refresh_interval_s
            while not self._stop and _time.monotonic() < deadline:
                _time.sleep(min(0.1, self.refresh_interval_s))
        source_handle.close()

    def on_stop(self) -> None:
        self._stop = True


def _load_yaml_config(config) -> dict:
    if isinstance(config, dict):
        return config
    import yaml

    with open(config) as f:
        text = f.read()
    # ${ENV_VAR} interpolation (reference airbyte_serverless connections)
    text = os.path.expandvars(text)
    return yaml.safe_load(text)


def read(
    config_file_path,
    streams: Sequence[str],
    *,
    mode: str = "streaming",
    execution_type: str = "local",
    env_vars: dict[str, str] | None = None,
    refresh_interval_ms: int = 60000,
    enforce_method: str | None = None,
    dependency_overrides: Sequence[str] | None = None,
    name: str | None = None,
    **kwargs,
):
    """Stream an Airbyte source's records as a table (stream, data) —
    reference signature: io/airbyte/__init__.py:read.

    The YAML config carries `source:` with one of `exec` (argv — the
    executable seam), `docker_image`, or `connector` (PyPI name)."""
    if execution_type != "local":
        raise NotImplementedError(
            "remote airbyte execution is cloud-specific in the reference; "
            "this framework runs connectors locally"
        )
    conf = _load_yaml_config(config_file_path)
    src_conf = conf.get("source", conf)
    inner = src_conf.get("config", {})
    if "exec" in src_conf:
        source: AbstractAirbyteSource = ExecutableAirbyteSource(
            src_conf["exec"], inner, streams, env_vars
        )
    elif enforce_method == "docker" or (
        "docker_image" in src_conf and enforce_method != "pypi"
        and "connector" not in src_conf
    ):
        source = DockerAirbyteSource(
            src_conf["docker_image"], inner, streams, env_vars
        )
    elif "connector" in src_conf or "docker_image" in src_conf:
        name_ = src_conf.get("connector") or src_conf["docker_image"]
        source = VenvAirbyteSource(
            name_, inner, streams, env_vars,
            dependency_overrides=dependency_overrides,
        )
    else:
        raise ValueError(
            "airbyte source config needs one of: exec, docker_image, connector"
        )

    subject = _AirbyteSubject(
        source, mode, refresh_interval_s=refresh_interval_ms / 1000.0
    )
    from ..internals.datasource import SubjectDataSource

    ds = SubjectDataSource(subject, subject._colnames, None, append_only=False)
    schema = schema_builder(
        {
            "stream": ColumnDefinition(dtype=dt.STR),
            "data": ColumnDefinition(dtype=dt.JSON),
        },
        name="AirbyteRecord",
    )
    return make_input_table(schema, ds, name=name or "airbyte", persistent_id=kwargs.get("persistent_id"))
