"""Per-tenant bearer-token authentication for the TCP transport — the port's copy of
``pulsar_tlaplus_tpu/service/auth.py`` (pure Python, no device).

The daemon's unix socket stays the no-auth localhost path (filesystem
permissions *are* the trust model there); the TCP listener (``serve
--tcp HOST:PORT``) requires every request to carry an ``auth`` field
whose value matches a token in the daemon's ``tokens.json``:

```json
{
  "tokens_v": 1,
  "tenants": [
    {"tenant": "ci-pulsar", "token": "s3cret-string"},
    {"tenant": "alice",     "token": "another-secret"}
  ]
}
```

Design rules:

- **Constant-time compare.**  A presented token is compared against
  *every* configured token with ``hmac.compare_digest`` and no early
  exit, so neither membership nor prefix length leaks through timing.
- **Tenant identity is derived, never claimed.**  The matched entry's
  ``tenant`` is attached to the job and to every telemetry record the
  daemon emits for it (``run_header.tenant`` at schema v10) — a client
  cannot name its own tenant over TCP.
- **Validated at load.**  :func:`load_tokens` rejects malformed files,
  duplicate tokens, duplicate tenants, and empty strings loudly at
  daemon startup, and ``scripts/torch_check_telemetry_schema.py --tokens``
  runs the same validation in CI.
"""

from __future__ import annotations

import hmac
import json
import re
from typing import Dict, List, Optional

TOKENS_VERSION = 1

# tenant names flow into metric labels, telemetry fields, log lines,
# and the admission counter keys — keep them to a boring identifier
# charset so no consumer needs escaping rules
TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

# the tenant attached to unauthenticated unix-socket submits (trusted
# localhost — same operator who can read the state dir)
LOCAL_TENANT = "local"

# the tenant the fleet dispatcher authenticates AS when it talks to
# its backends (fleet/): the replication verbs (warm_list /
# warm_offer / warm_pull / warm_push) are fleet-internal — over TCP
# they answer only this tenant (or trusted unix-socket callers), so
# an ordinary tenant token can never siphon another tenant's warm
# artifacts off a backend.  Deployments give the dispatcher its own
# tokens.json entry under this name.
FLEET_TENANT = "fleet"


def validate_tokens_obj(obj, label: str = "tokens.json") -> List[str]:
    """All shape violations in a parsed tokens object (empty list =
    valid).  Shared by :func:`load_tokens` and the CI validator."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return [f"{label}: not a JSON object"]
    v = obj.get("tokens_v")
    if not isinstance(v, int) or v < 1:
        errors.append(f"{label}: missing/bad tokens_v {v!r}")
    elif v > TOKENS_VERSION:
        errors.append(
            f"{label}: tokens_v {v} newer than supported "
            f"{TOKENS_VERSION}"
        )
    tenants = obj.get("tenants")
    if not isinstance(tenants, list) or not tenants:
        errors.append(f"{label}: 'tenants' must be a non-empty list")
        return errors
    seen_tokens: set = set()
    seen_tenants: set = set()
    for i, e in enumerate(tenants):
        where = f"{label}: tenants[{i}]"
        if not isinstance(e, dict):
            errors.append(f"{where}: not an object")
            continue
        tenant, token = e.get("tenant"), e.get("token")
        if not isinstance(tenant, str) or not tenant:
            errors.append(f"{where}: missing/empty 'tenant'")
        elif not TENANT_RE.match(tenant):
            errors.append(
                f"{where}: tenant {tenant!r} must match "
                f"{TENANT_RE.pattern} (it becomes metric labels and "
                "counter keys)"
            )
        elif tenant == LOCAL_TENANT:
            errors.append(
                f"{where}: tenant {LOCAL_TENANT!r} is reserved for "
                "unauthenticated unix-socket submits"
            )
        elif tenant in seen_tenants:
            errors.append(f"{where}: duplicate tenant {tenant!r}")
        else:
            seen_tenants.add(tenant)
        if not isinstance(token, str) or len(token) < 8:
            errors.append(
                f"{where}: 'token' must be a string of >= 8 chars"
            )
        elif token in seen_tokens:
            errors.append(f"{where}: duplicate token")
        else:
            seen_tokens.add(token)
    return errors


def validate_tokens_file(path: str) -> List[str]:
    """CI entry point (``torch_check_telemetry_schema.py --tokens``)."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable ({e})"]
    return validate_tokens_obj(obj, label=path)


def load_tokens(path: str) -> Dict[str, str]:
    """tokens.json -> {token: tenant}; raises ValueError on any shape
    violation (the daemon must fail fast at startup, not at the first
    hostile connect).  Parses ONCE and validates the in-memory object
    — the loaded mapping is exactly what was validated, even if the
    file is replaced underneath."""
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: unreadable ({e})") from e
    errors = validate_tokens_obj(obj, label=path)
    if errors:
        raise ValueError("; ".join(errors))
    return {e["token"]: e["tenant"] for e in obj["tenants"]}


def authenticate(
    tokens: Dict[str, str], presented: Optional[str]
) -> Optional[str]:
    """The tenant owning ``presented``, or None.  Compares against
    EVERY configured token with no early exit — membership and match
    position never leak through timing."""
    if not isinstance(presented, str) or not tokens:
        # still burn one comparison so the absent-token path is not
        # observably faster than the wrong-token path
        hmac.compare_digest(b"x" * 16, b"y" * 16)
        return None
    # compare as bytes: compare_digest raises TypeError on non-ASCII
    # str operands, and a hostile peer must not be able to kill the
    # handler thread with a curated token
    presented_b = presented.encode("utf-8", "surrogatepass")
    found: Optional[str] = None
    for token, tenant in tokens.items():
        if hmac.compare_digest(token.encode("utf-8"), presented_b):
            found = tenant
    return found
