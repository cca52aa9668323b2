"""AWS SigV4 request signing + JSON-RPC and REST transport over urllib —
the shared plumbing of the kinesis and dynamodb connectors and of
Bedrock's Converse chat (reference uses the rusoto/aws SDK crates; the
signing algorithm is public and ~40 lines).

The port of ``pathway_tpu/io/_aws.py``: the same signatures.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import urllib.parse
import urllib.request


class AwsCredentials:
    def __init__(self, access_key: str, secret_key: str, region: str,
                 session_token: str | None = None):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.session_token = session_token


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _amz_now(amz_date: str | None) -> str:
    return amz_date or datetime.datetime.now(
        datetime.timezone.utc
    ).strftime("%Y%m%dT%H%M%SZ")


def _sign(creds: AwsCredentials, service: str, now: str, headers: dict,
          canonical_uri: str, body: bytes) -> dict:
    """``headers`` (every one signed) with the SigV4 ``authorization`` of
    a POST of ``body`` to ``canonical_uri`` added."""
    if creds.session_token:
        headers["x-amz-security-token"] = creds.session_token
    datestamp = now[:8]
    signed_headers = ";".join(sorted(headers))
    canonical = "\n".join([
        "POST", canonical_uri, "",
        "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
        signed_headers, hashlib.sha256(body).hexdigest(),
    ])
    scope = f"{datestamp}/{creds.region}/{service}/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", now, scope,
        hashlib.sha256(canonical.encode()).hexdigest(),
    ])
    k = _hmac(f"AWS4{creds.secret_key}".encode(), datestamp)
    k = _hmac(k, creds.region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    headers["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={creds.access_key}/{scope}, "
        f"SignedHeaders={signed_headers}, Signature={signature}"
    )
    return headers


def sign_request(creds: AwsCredentials, service: str, host: str,
                 target: str, body: bytes,
                 amz_date: str | None = None) -> dict:
    """Headers for a signed POST / (the JSON-RPC style AWS APIs)."""
    now = _amz_now(amz_date)
    headers = {
        "content-type": "application/x-amz-json-1.0",
        "host": host,
        "x-amz-date": now,
        "x-amz-target": target,
    }
    return _sign(creds, service, now, headers, "/", body)


def _host(service: str, creds: AwsCredentials, endpoint: str | None) -> str:
    return (endpoint.split("://", 1)[-1].split("/")[0]
            if endpoint else f"{service}.{creds.region}.amazonaws.com")


def aws_call(creds: AwsCredentials, service: str, target: str,
             payload: dict, *, endpoint: str | None = None,
             _http=None) -> dict:
    """One signed JSON call (e.g. target='Kinesis_20131202.PutRecords')."""
    host = _host(service, creds, endpoint)
    url = endpoint or f"https://{host}/"
    body = json.dumps(payload).encode()
    headers = sign_request(creds, service, host, target, body)
    if _http is not None:  # test seam
        return _http(url, target, payload, headers)
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        out = resp.read()
    return json.loads(out) if out.strip() else {}


def sign_rest_request(creds: AwsCredentials, service: str, host: str,
                      path: str, body: bytes,
                      content_type: str = "application/json",
                      amz_date: str | None = None) -> dict:
    """Headers for a signed REST-style POST {path} (e.g. Bedrock Converse:
    POST /model/{modelId}/converse).  Canonical URI is the URI-encoded
    path; otherwise identical SigV4 flow to sign_request."""
    now = _amz_now(amz_date)
    headers = {"content-type": content_type, "host": host, "x-amz-date": now}
    # SigV4 for non-S3 services canonicalizes the DOUBLE-encoded path (the
    # wire URL carries single encoding; AWS re-encodes it server-side when
    # building its own canonical request — botocore does the same)
    canonical_uri = urllib.parse.quote(urllib.parse.quote(path, safe="/"),
                                       safe="/")
    return _sign(creds, service, now, headers, canonical_uri, body)


def aws_rest_call(creds: AwsCredentials, service: str, path: str,
                  payload: dict, *, endpoint: str | None = None,
                  _http=None) -> dict:
    """One signed REST POST (e.g. bedrock-runtime /model/{id}/converse)."""
    host = _host(service, creds, endpoint)
    url = (endpoint or f"https://{host}").rstrip("/") + urllib.parse.quote(
        path, safe="/")
    body = json.dumps(payload).encode()
    headers = sign_rest_request(creds, service, host, path, body)
    if _http is not None:  # test seam
        return _http(url, path, payload, headers)
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())
