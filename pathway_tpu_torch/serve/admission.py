"""The serving plane's typed engine failure (the port's copy of
``pathway_tpu/serve/admission.py``'s ``EngineFailedError``)."""

from __future__ import annotations


class EngineFailedError(RuntimeError):
    """A request died because the decode engine failed and its restart
    budget, if any, ran out.  Admission rejected nothing; the device tier
    broke.  An HTTP front maps it to ``503 + Retry-After``.

    Attributes: ``retry_after_s`` (hint for the 503), ``trace_id`` (the
    engine run that failed) and ``dump_path`` (a flight-recorder dump of
    the failure, when one was written)."""

    def __init__(self, reason: str, *, retry_after_s: float = 5.0,
                 trace_id: str | None = None, dump_path: str | None = None):
        super().__init__(reason)
        self.retry_after_s = max(0.0, float(retry_after_s))
        self.trace_id = trace_id
        self.dump_path = dump_path


__all__ = ["EngineFailedError"]
