"""License / entitlements gating (the port of
``pathway_tpu/internals/licensing.py``; reference: src/engine/license.rs +
internals/config.py _check_entitlements).

The reference validates keys against a license server or an offline signed
license and gates ~25 features (xpack-sharepoint, xpack-llm-mcp,
advanced-parser, vector-DB writers, ...).  This implementation is fully
offline (zero egress):

- no key: gated features raise ``InsufficientLicenseError`` with the
  reference's get-a-free-key message
- demo keys (``demo-license-key-with-telemetry`` /
  ``demo-license-key-no-telemetry``): grant the standard entitlement set,
  mirroring the reference's free tier
- offline keys ``pathway-tpu:v1:<ent1,ent2,...>[:<hmac>]``: explicit
  entitlement list; when ``PATHWAY_LICENSE_SIGNING_KEY`` is set the hmac
  segment must verify (enterprise offline deployments); ``*`` grants all
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os

GET_KEY_MSG = (
    "require a license key, which is free.\nGet one at "
    "https://pathway.com/framework/get-license, then call "
    "pw.set_license_key(...) or set the PATHWAY_LICENSE_KEY "
    "environment variable."
)

#: the free/demo tier — the same feature list the reference gates with
#: _check_entitlements (grep over python/pathway: 25 call sites)
STANDARD_ENTITLEMENTS = frozenset({
    "xpack-sharepoint", "xpack-llm-mcp", "advanced-parser", "leann",
    "dynamodb", "chromadb", "pinecone", "qdrant", "milvusdb", "weaviate",
    "deltalake", "iceberg", "bigquery", "monitoring", "rabbitmq",
    "elasticsearch", "questdb", "mysql", "mssql", "mongodb-oplog-reader",
    "kinesis", "duckdb", "clickhouse", "postgres-wal-reader",
    "multiple-machines",
})

DEMO_KEYS = {
    "demo-license-key-with-telemetry": True,   # -> telemetry_required
    "demo-license-key-no-telemetry": False,
}


class LicenseError(RuntimeError):
    pass


class MissingLicenseError(LicenseError):
    pass


class InsufficientLicenseError(LicenseError):
    pass


class License:
    def __init__(self, entitlements: frozenset[str], *,
                 telemetry_required: bool = False, tier: str = "standard"):
        self.entitlements = entitlements
        self.telemetry_required = telemetry_required
        self.tier = tier

    def allows(self, ent: str) -> bool:
        return "*" in self.entitlements or ent in self.entitlements


def parse_license(key: str | None) -> License | None:
    """None for no key; raises LicenseError on malformed/unverified keys.

    When ``PATHWAY_LICENSE_SIGNING_KEY`` is set, ONLY hmac-signed offline
    keys are honored — demo and free-form keys are rejected, so the
    signing requirement cannot be bypassed by switching key shapes.
    """
    if not key:
        return None
    key = key.strip()
    signing = os.environ.get("PATHWAY_LICENSE_SIGNING_KEY")
    if key.startswith("pathway-tpu:v1:"):
        parts = key.split(":")
        if signing:
            if len(parts) < 4:
                raise InsufficientLicenseError(
                    "offline license is unsigned but "
                    "PATHWAY_LICENSE_SIGNING_KEY is set"
                )
            # mac is the LAST segment, computed over everything before it —
            # extra trailing segments cannot ride along unverified
            body = ":".join(parts[:-1])
            expect = _hmac.new(
                signing.encode(), body.encode(), hashlib.sha256,
            ).hexdigest()[:32]
            if not _hmac.compare_digest(expect, parts[-1]):
                raise InsufficientLicenseError("offline license signature "
                                               "does not verify")
            ents_str = ":".join(parts[2:-1])
        else:
            if len(parts) not in (3, 4):
                raise InsufficientLicenseError("malformed offline license")
            ents_str = parts[2]
        ents = frozenset(e for e in ents_str.split(",") if e)
        return License(ents, tier="enterprise" if "*" in ents else "scale")
    if signing:
        raise InsufficientLicenseError(
            "PATHWAY_LICENSE_SIGNING_KEY is set: only signed offline "
            "licenses (pathway-tpu:v1:<entitlements>:<mac>) are accepted"
        )
    if key in DEMO_KEYS:
        return License(STANDARD_ENTITLEMENTS,
                       telemetry_required=DEMO_KEYS[key])
    # unknown key shapes are accepted as the standard tier (the reference
    # validates online; offline we extend good faith to real keys) — but
    # loudly, so a typo'd or fabricated key is visible to the operator
    # instead of silently unlocking the standard entitlements
    import logging

    logging.getLogger(__name__).warning(
        "license key %r is not a recognized demo key or signed offline "
        "key; treating it as the standard tier in good faith — verify the "
        "key if entitlement gating matters in this deployment",
        key[:16] + "..." if len(key) > 16 else key,
    )
    return License(STANDARD_ENTITLEMENTS)


def sign_offline_key(entitlements: str, signing_key: str) -> str:
    """Produce a signed offline key for `pathway-tpu:v1:<entitlements>`.
    `entitlements` is a comma-separated list; ':' is reserved."""
    if ":" in entitlements:
        raise ValueError("entitlements must not contain ':'")
    mac = _hmac.new(
        signing_key.encode(), f"pathway-tpu:v1:{entitlements}".encode(),
        hashlib.sha256,
    ).hexdigest()[:32]
    return f"pathway-tpu:v1:{entitlements}:{mac}"


def check_entitlements(*entitlements: str) -> None:
    """Raise unless the configured license grants every entitlement
    (reference: api.check_entitlements)."""
    from .config import get_pathway_config

    lic = parse_license(get_pathway_config().license_key)
    if lic is None:
        raise MissingLicenseError(
            f"the feature(s) you used {list(entitlements)!r} " + GET_KEY_MSG
        )
    missing = [e for e in entitlements if not lic.allows(e)]
    if missing:
        raise InsufficientLicenseError(
            f"insufficient license: {missing!r} not in the "
            f"{lic.tier!r} tier. " + GET_KEY_MSG
        )
