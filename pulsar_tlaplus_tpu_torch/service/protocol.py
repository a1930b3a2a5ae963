"""Wire protocol: JSONL request/response over unix or TCP sockets — the port's copy of
``pulsar_tlaplus_tpu/service/protocol.py`` (pure Python, no device).

One connection carries one request and its response(s).  Every message
is a single JSON object on one ``\\n``-terminated line (the same
crash-durable line discipline as the telemetry streams):

- request: ``{"op": "submit", ...}`` — over TCP, additionally an
  ``"auth": "<bearer token>"`` field (service/auth.py); ``"mode":
  "simulate"`` + a ``"sim"`` knob object queue a streaming
  walker-swarm job instead of exhaustive BFS
- response: ``{"ok": true, ...}`` or ``{"ok": false, "error": "...",
  "code": "..."}`` — ``code`` is the TYPED rejection class the client
  maps to a distinct exit code: ``auth`` (bad/missing token),
  ``quota`` (per-tenant quota), ``capacity`` (global load shed),
  ``bad_request`` / ``protocol`` (everything else)
- ``watch`` responses stream: one ``{"ok": true, "streaming": true}``
  acknowledgment, then ``{"event": {...}}`` lines relaying the job's
  telemetry records (level progress, heartbeat, per-slice run headers
  — each under the slice's run_id), terminated by ``{"done": {...}}``
  with the job summary + result.

Addresses: a filesystem path is a unix socket (reachability IS
filesystem permissions — the no-auth localhost path); ``tcp://HOST:
PORT`` is the authenticated open-network path (``serve --tcp``).
"""

from __future__ import annotations

import json
import os
import socket
from typing import Iterator, Optional

# requests the daemon understands (server.py dispatch table).
# ``metrics`` answers a Prometheus text exposition rendered from
# scheduler state + last-fetched engine stats — a scrape never adds a
# device sync.
# ``warm_list``/``warm_offer``/``warm_pull``/``warm_push`` are the fleet
# replication verbs (``fleet/replicate.py``): the dispatcher sieves a
# completed job's warm artifact across backends — digests first, only the
# blobs a peer is missing, each delta-compressed with the plane codec
# (``store/compress.py``).
OPS = (
    "ping", "submit", "status", "result", "cancel", "watch",
    "metrics", "shutdown",
    "warm_list", "warm_offer", "warm_pull", "warm_push",
)

# one message must fit memory comfortably; traces are bounded by spec
# diameter, so this is generous
MAX_LINE = 32 << 20

# client-supplied scheduling priority is clamped into this range at
# the daemon's door: (priority, FIFO) claim order + level-boundary
# preemption mean an unbounded value would let one tenant starve
# every other — quotas cap job counts, this caps the knob itself
PRIORITY_MIN = -9
PRIORITY_MAX = 9


class ProtocolError(RuntimeError):
    """Malformed frame / oversized line / unexpected EOF."""


TCP_PREFIX = "tcp://"


def is_tcp(address: str) -> bool:
    return address.startswith(TCP_PREFIX)


def parse_tcp(address: str):
    """``tcp://HOST:PORT`` -> (host, port); raises ValueError with a
    usable message on malformed input."""
    body = address[len(TCP_PREFIX):]
    host, sep, port_s = body.rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"bad TCP address {address!r} (want tcp://HOST:PORT)"
        )
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(
            f"bad TCP port in {address!r} (want tcp://HOST:PORT)"
        ) from None
    if not 0 <= port <= 65535:
        raise ValueError(f"TCP port out of range in {address!r}")
    return host, port


def send_json(wfile, obj: dict) -> None:
    """One message = one write of one complete line (a crashed peer
    can tear at most the line in flight)."""
    wfile.write(json.dumps(obj) + "\n")
    wfile.flush()


def recv_json(rfile) -> Optional[dict]:
    """Next message, or None on clean EOF."""
    line = rfile.readline(MAX_LINE + 1)
    if not line:
        return None
    if len(line) > MAX_LINE:
        raise ProtocolError(f"message exceeds {MAX_LINE} bytes")
    line = line.strip()
    if not line:
        return None
    try:
        obj = json.loads(line)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"unparseable message: {e}") from e
    if not isinstance(obj, dict):
        raise ProtocolError("message is not a JSON object")
    return obj


def connect(address: str, timeout: Optional[float] = 10.0):
    """Client-side connect to a unix path or ``tcp://HOST:PORT``;
    raises FileNotFoundError/ConnectionError with the address in the
    message (the usual failure is a daemon that is not running)."""
    if is_tcp(address):
        host, port = parse_tcp(address)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.settimeout(timeout)
        try:
            s.connect((host, port))
        except OSError:
            s.close()
            raise
        return s
    if not os.path.exists(address):
        raise FileNotFoundError(
            f"no daemon socket at {address!r} (is `serve` running?)"
        )
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(address)
    except OSError:
        s.close()
        raise
    return s


def request(
    socket_path: str, op: str, timeout: Optional[float] = 10.0, **fields
) -> dict:
    """One request -> the single (non-streaming) response."""
    with connect(socket_path, timeout) as s:
        r = s.makefile("r", encoding="utf-8")
        w = s.makefile("w", encoding="utf-8")
        send_json(w, {"op": op, **fields})
        resp = recv_json(r)
    if resp is None:
        raise ProtocolError(f"daemon closed the connection on {op!r}")
    return resp


def stream(
    socket_path: str, op: str, timeout: Optional[float] = None, **fields
) -> Iterator[dict]:
    """One request -> the streaming response sequence (``watch``):
    yields every message after the acknowledgment, ending naturally at
    the terminating ``done`` message (which is yielded too)."""
    with connect(socket_path, timeout) as s:
        r = s.makefile("r", encoding="utf-8")
        w = s.makefile("w", encoding="utf-8")
        send_json(w, {"op": op, **fields})
        ack = recv_json(r)
        if ack is None:
            raise ProtocolError(f"daemon closed the connection on {op!r}")
        if not ack.get("ok"):
            yield ack
            return
        if not ack.get("streaming"):
            yield ack
            return
        while True:
            msg = recv_json(r)
            if msg is None:
                return
            yield msg
            if "done" in msg or "error" in msg:
                return


def error_response(msg: str, code: str = "bad_request") -> dict:
    """Typed refusal: ``code`` is the machine-readable rejection
    class (``auth`` / ``quota`` / ``capacity`` / ``bad_request`` /
    ``protocol`` / ``backend_unavailable``) the client maps to its
    distinct exit code.  ``backend_unavailable`` is the
    dispatcher's rejection when no healthy backend can take the
    request — a TRANSPORT-class failure (client exit 2, retryable
    with the client's retry budget), never a verification verdict."""
    return {"ok": False, "error": msg, "code": code}
