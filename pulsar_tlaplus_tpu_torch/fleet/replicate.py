"""Warm-artifact replication: the fleet's sieve handshake — the port's
copy of ``pulsar_tlaplus_tpu/fleet/replicate.py``.

One completed job leaves one digest-verified warm artifact on its
owning backend (warm/store.py).  This module moves it to every peer
so a resubmit landing ANYWHERE warm-starts, with the wire discipline
of Compression-and-Sieve (arXiv:1208.5542): never ship what the peer
already holds, and compress what does ship.

The handshake, dispatcher-orchestrated (no backend talks to another
backend — the dispatcher is the only component that knows the fleet):

1. ``warm_list`` on the owner: every artifact's manifest (small JSON
   — the per-file SHA-256 digests ARE the sieve's membership test).
2. ``warm_offer`` to the peer with one manifest: the peer diffs the
   digests against its own store and answers ``need`` — exactly the
   rels it is missing or holds with different bytes.  An identical
   manifest answers ``identical`` and the pass ends at zero bytes.
3. ``warm_pull`` from the owner, one needed rel at a time: the file's
   bytes ride the plane codec (store/compress.py — pad to a
   4-byte multiple, view as uint32, delta+zlib) base64'd into the
   JSONL frame.
4. ``warm_push`` to the peer: the verbatim manifest + only the needed
   blobs.  The peer stages, re-verifies every digest byte-for-byte,
   reuses its matching local blobs, and swaps the artifact in
   atomically (``WarmStore.install``) — a torn or hostile push can
   never replace a good artifact.

Server-side halves of each verb live here too (server.py delegates),
so the digest-diff logic exists exactly once.  The port's
``WarmStore.install`` refuses a manifest without its ``port`` tag, so a
JAX-package artifact never installs here (nor the reverse).

A pulled blob travels as ONE protocol line: a file whose encoded line
exceeds ``protocol.MAX_LINE`` (a full-width ``frame.npz`` of the scaled
binding is 1-2 GB) cannot cross, and its pass ends ``unreachable``
after the owner has read and encoded the whole file.  The JAX package
behaves the same; there is no chunked pull.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from pulsar_tlaplus_tpu_torch.service import protocol
from pulsar_tlaplus_tpu_torch.store import compress

# ------------------------------------------------------------- codec


def encode_blob(data: bytes) -> Tuple[str, int, int]:
    """File bytes -> (base64 text, raw byte count, wire byte count)
    through the payload-plane codec: pad to a 4-byte multiple,
    view as uint32 words, delta+zlib encode.  The raw count travels
    beside the blob because the padding is not self-describing."""
    pad = (-len(data)) % 4
    arr = np.frombuffer(data + b"\x00" * pad, dtype=np.uint32)
    blob, _raw, _comp = compress.encode_plane(arr, compress=True)
    return base64.b64encode(blob).decode("ascii"), len(data), len(blob)


def decode_blob(b64: str, raw_bytes: int) -> bytes:
    """Inverse of :func:`encode_blob` (truncates the pad)."""
    arr = compress.decode_plane(base64.b64decode(b64))
    return arr.tobytes()[: int(raw_bytes)]


# ---------------------------------------------- backend (server) side


def list_artifacts(store) -> List[dict]:
    """``warm_list`` body: every readable artifact's manifest.  The
    manifests are small JSON; their ``files`` digest tables are what
    the peer sieves against."""
    out = []
    for adir, man in store.manifests():
        out.append({"dir": os.path.basename(adir), "manifest": man})
    return out


def diff_needed(store, manifest: dict) -> dict:
    """``warm_offer`` body: which of ``manifest``'s rels this store
    must be shipped (missing, or held with different bytes).  An
    artifact whose local manifest is byte-identical (sorted JSON)
    answers ``identical`` so the pass costs zero data messages."""
    files = manifest.get("files")
    sig = manifest.get("config_sig")
    if not isinstance(files, dict) or not isinstance(sig, str):
        raise ValueError("offer manifest missing files/config_sig")
    adir = store.dir_for(sig)
    local: Dict[str, dict] = {}
    identical = False
    try:
        local_man = store.load_manifest(adir)
        local = dict(local_man.get("files") or {})
        identical = json.dumps(local_man, sort_keys=True) == json.dumps(
            manifest, sort_keys=True
        )
    except (ValueError, OSError):
        local = {}
    need, have = [], []
    for rel, meta in sorted(files.items()):
        lm = local.get(rel)
        if (
            isinstance(lm, dict)
            and lm.get("sha256") == (meta or {}).get("sha256")
            and os.path.isfile(os.path.join(adir, rel))
        ):
            have.append(rel)
        else:
            need.append(rel)
    return {"need": need, "have": have, "identical": identical}


def read_blob(store, config_sig: str, rel: str) -> dict:
    """``warm_pull`` body: one manifest-listed file, codec-encoded.
    ``rel`` comes off the wire — it must be a rel the manifest lists
    AND resolve inside the artifact dir."""
    adir = store.dir_for(config_sig)
    man = store.load_manifest(adir)  # ValueError on torn/missing
    files = man.get("files") or {}
    if rel not in files:
        raise ValueError(f"rel {rel!r} not in the artifact manifest")
    path = os.path.join(adir, rel)
    if not os.path.realpath(path).startswith(
        os.path.realpath(adir) + os.sep
    ):
        raise ValueError(f"unsafe rel {rel!r}")
    with open(path, "rb") as f:
        data = f.read()
    b64, raw, wire = encode_blob(data)
    return {
        "rel": rel,
        "data": b64,
        "raw_bytes": raw,
        "wire_bytes": wire,
        "sha256": (files[rel] or {}).get("sha256"),
    }


def install_push(store, manifest: dict, blobs: dict) -> Tuple[Optional[str], str]:
    """``warm_push`` body: decode the shipped blobs and install,
    reusing this store's existing artifact for the blobs the sieve
    skipped.  Returns ``(adir, reason)`` from ``WarmStore.install``
    — the digest re-verification there is what makes a hostile or
    torn push harmless."""
    if not isinstance(manifest, dict) or not isinstance(blobs, dict):
        raise ValueError("push needs manifest + blobs objects")
    decoded: Dict[str, bytes] = {}
    for rel, b in blobs.items():
        if not isinstance(b, dict):
            raise ValueError(f"blob {rel!r} is not an object")
        decoded[str(rel)] = decode_blob(
            str(b.get("data", "")), int(b.get("raw_bytes", 0))
        )
    sig = manifest.get("config_sig")
    reuse = store.dir_for(sig) if isinstance(sig, str) else None
    if reuse is not None and not os.path.isdir(reuse):
        reuse = None
    return store.install(manifest, decoded, reuse_from=reuse)


# ------------------------------------------- dispatcher (client) side


def _auth(token: Optional[str]) -> dict:
    return {"auth": token} if token else {}


def replicate_artifact(
    src_addr: str,
    dst_addr: str,
    manifest: dict,
    token: Optional[str] = None,
    timeout: float = 30.0,
) -> dict:
    """One owner -> peer sieve pass for one artifact.  Returns
    ``{"status", "blobs", "wire_bytes"}`` — status ``ok`` (installed),
    ``identical`` (peer already current, zero data messages), or a
    typed failure string.  Never raises on a refusing peer; transport
    errors (socket death) propagate to the caller's failover logic."""
    offer = protocol.request(
        dst_addr, "warm_offer", timeout=timeout,
        manifest=manifest, **_auth(token),
    )
    if not offer.get("ok"):
        return {
            "status": f"offer_refused: {offer.get('error')}",
            "blobs": 0, "wire_bytes": 0,
        }
    if offer.get("identical"):
        return {"status": "identical", "blobs": 0, "wire_bytes": 0}
    need = [str(r) for r in (offer.get("need") or [])]
    blobs: Dict[str, dict] = {}
    wire = 0
    sig = manifest.get("config_sig")
    for rel in need:
        want = ((manifest.get("files") or {}).get(rel) or {}).get(
            "sha256"
        )
        pull = None
        # digest-verify the pulled bytes against the MANIFEST before
        # they ride to the peer: a blob corrupted in flight or
        # torn by a partition is quarantined (dropped, never pushed)
        # and re-pulled once — the peer's install would catch it too,
        # but failing the whole artifact there costs a full re-sieve
        for attempt in (0, 1):
            pull = protocol.request(
                src_addr, "warm_pull", timeout=timeout,
                config_sig=sig, rel=rel, **_auth(token),
            )
            if not pull.get("ok"):
                return {
                    "status": f"pull_refused: {pull.get('error')}",
                    "blobs": 0, "wire_bytes": 0,
                }
            wire += int(pull.get("wire_bytes") or 0)
            if want is None:
                break
            try:
                data = decode_blob(
                    str(pull.get("data", "")),
                    int(pull.get("raw_bytes", 0)),
                )
                got = hashlib.sha256(data).hexdigest()
            except Exception:  # noqa: BLE001 — any decode failure
                #                (bad base64, zlib error, torn blob)
                #                is the same verdict: not the bytes
                #                the manifest promised
                got = None
            if got == want:
                break
            pull = None
            if attempt == 1:
                return {
                    "status": f"pull_corrupt: {rel!r} digest "
                    "mismatch twice (quarantined, nothing pushed)",
                    "blobs": 0, "wire_bytes": wire,
                }
        blobs[rel] = {
            "data": pull.get("data"),
            "raw_bytes": pull.get("raw_bytes"),
        }
    push = protocol.request(
        dst_addr, "warm_push", timeout=timeout,
        manifest=manifest, blobs=blobs, **_auth(token),
    )
    if not push.get("ok"):
        return {
            "status": f"push_refused: {push.get('error')}",
            "blobs": len(blobs), "wire_bytes": wire,
        }
    if push.get("reason") != "ok":
        return {
            "status": f"install_failed: {push.get('reason')}",
            "blobs": len(blobs), "wire_bytes": wire,
        }
    return {"status": "ok", "blobs": len(blobs), "wire_bytes": wire}


def replicate_all(
    src_addr: str,
    peer_addrs: List[str],
    token: Optional[str] = None,
    timeout: float = 30.0,
    on_pass=None,
) -> List[dict]:
    """Every artifact on ``src_addr``, sieved to every peer.  Repeated
    passes are cheap by construction: a peer that already holds an
    artifact answers ``identical`` at step 2 and no data moves.
    ``on_pass(dict)`` (if given) sees one record per (artifact, peer)
    pass — the dispatcher's ``replicate`` telemetry hook.  Transport
    errors against ONE peer skip that peer (recorded as
    ``unreachable``), never the whole pass."""
    listing = protocol.request(
        src_addr, "warm_list", timeout=timeout, **_auth(token)
    )
    if not listing.get("ok"):
        return [{
            "status": f"list_refused: {listing.get('error')}",
            "src": src_addr, "dst": None, "blobs": 0, "wire_bytes": 0,
        }]
    results = []
    for entry in listing.get("artifacts") or []:
        man = entry.get("manifest")
        if not isinstance(man, dict):
            continue
        for dst in peer_addrs:
            if dst == src_addr:
                continue
            try:
                r = replicate_artifact(
                    src_addr, dst, man, token=token, timeout=timeout
                )
            except (OSError, protocol.ProtocolError) as e:
                r = {
                    "status": f"unreachable: {e!r:.80}",
                    "blobs": 0, "wire_bytes": 0,
                }
            r.update({
                "src": src_addr, "dst": dst,
                "config_sig": man.get("config_sig"),
            })
            results.append(r)
            if on_pass is not None:
                on_pass(r)
    return results
