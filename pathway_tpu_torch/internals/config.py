"""Env-var backed configuration (the port of
``pathway_tpu/internals/config.py``; reference: internals/config.py:199).

All knobs are also settable programmatically.  Licensing gates the same
features the JAX package gates (``internals/licensing.py``): a free demo
key or an offline signed key unlocks them.  ``pw.run`` reads the
cluster's knobs (``threads``, ``processes``, ``process_id``,
``first_port``), which the ``spawn`` supervisor sets in each worker's
environment.
"""

from __future__ import annotations

import dataclasses
import os


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class PathwayConfig:
    license_key: str | None = os.environ.get("PATHWAY_LICENSE_KEY")
    monitoring_server: str | None = os.environ.get("PATHWAY_MONITORING_SERVER")
    run_id: str = os.environ.get("PATHWAY_RUN_ID", "")
    persistent_storage: str | None = os.environ.get("PATHWAY_PERSISTENT_STORAGE")
    ignore_asserts: bool = _env_bool("PATHWAY_IGNORE_ASSERTS")
    threads: int = int(os.environ.get("PATHWAY_THREADS", "1"))
    processes: int = int(os.environ.get("PATHWAY_PROCESSES", "1"))
    process_id: int = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    first_port: int = int(os.environ.get("PATHWAY_FIRST_PORT", "10000"))
    terminate_on_error: bool = True


pathway_config = PathwayConfig()


def get_pathway_config() -> PathwayConfig:
    return pathway_config


def set_license_key(key: str | None) -> None:
    """Set (or clear) the license key.  Malformed offline keys surface
    immediately (reference: set_license_key + License::new)."""
    if key is not None:
        from .licensing import parse_license

        parse_license(key)  # validate eagerly; raises LicenseError
    pathway_config.license_key = key


def _check_entitlements(*entitlements: str) -> None:
    """Gate a feature on the configured license (reference:
    internals/config.py _check_entitlements -> api.check_entitlements)."""
    from .licensing import check_entitlements

    check_entitlements(*entitlements)


def set_monitoring_config(*, server_endpoint: str | None = None) -> None:
    pathway_config.monitoring_server = server_endpoint
