"""Wire framing for the pod's TCP transport.

The pipe transport (`multiprocessing.connection`) pickles every message
— including the full input array of every submit and the full
attribution of every result — once per hop. On one host that is a
memcpy tax; across hosts it is the hot path. This module is the framing
half of the replacement: a length-prefixed binary format where ndarray
payloads ride as RAW BUFFER FRAMES (the header carries shape/dtype; the
array bytes go to the socket straight from the array's own memory and
land in a freshly allocated array on the other side via ``recv_into``
— no pickle, no intermediate bytes object, no join) while the op-dict
scaffolding around them rides as a compact JSON header.

One message on the wire::

    b"WAMF" | u32 header_len | header JSON | buf 0 | buf 1 | ...

The header is ``{"m": <msg tree>, "b": [<buffer descriptors>]}``. Any
ndarray / bytes / unJSONable value in the tree is replaced by
``{"__buf__": i}`` and its payload appended to the buffer list:

- ``kind "nd"`` — C-contiguous array bytes; descriptor carries numpy
  ``dtype.str`` (endianness explicit), shape, and nbytes (validated
  against shape x itemsize on decode — a lying header is a
  `FrameError`, not a misread).
- ``kind "bytes"`` — raw bytes (registry bundle blobs ride this way).
- ``kind "pkl"`` — pickle fallback for the rare non-JSON scalar; the
  grammar's arrays NEVER take this path (that is the point).

Torch tensors: a host tensor is framed as its numpy view (the same bytes
as the array); a tensor on a device, or one in bfloat16 (which numpy has
no dtype for), is refused with a TypeError and never copied here — the
worker converts its results before they reach the encoder.

`WorkerSnapshot` heartbeat payloads cross as ``{"__snap__": {...}}`` —
structured, pickle-free, and versionable by field name.

Truncation discipline: a clean EOF at a message boundary is `EOFError`
(peer closed); bytes missing MID-message, a bad magic, or an absurd
header length are `FrameError` — which subclasses `OSError` so every
existing ``except (EOFError, OSError)`` recv loop in the pod already
handles it as a connection death.

The handshake reuses the pod's existing secret (`AUTHKEY_ENV`, hex in
the environment — never argv): a mutual HMAC-SHA256 challenge/response
(server challenges first, client proves and counter-challenges, server
proves back), constant-time compared. Each side also gets a free RTT
sample out of its proof round-trip — the router seeds its per-host RTT
EMA and the clock-offset estimate with it, so host-aware routing has a
signal before the first heartbeat lands.
"""

from __future__ import annotations

import hmac
import json
import os
import pickle
import socket
import struct
import sys
import time
from dataclasses import asdict

import numpy as np

from wam_tpu_torch.pod.protocol import WorkerSnapshot

__all__ = [
    "FrameError",
    "PodAuthError",
    "client_handshake",
    "encode_message",
    "read_message",
    "recv_exact",
    "send_buffers",
    "server_handshake",
]

MAGIC = b"WAMF"
_PRELUDE = struct.Struct("<4sI")  # magic + header length
# a header is op-dict scaffolding + buffer descriptors — never payload;
# anything past this is a corrupt or hostile frame, not a big message
MAX_HEADER_BYTES = 1 << 24

# handshake wire: magic + version + 16-byte nonce, then 32-byte HMACs
_HS_MAGIC = b"WAMH"
_HS_VERSION = 1
_NONCE_LEN = 16
_MAC_LEN = 32
_CLIENT_TAG = b"wam-tpu-pod-client|"
_SERVER_TAG = b"wam-tpu-pod-server|"
HANDSHAKE_TIMEOUT_S = 20.0

# sendmsg scatter lists are capped by the kernel's IOV_MAX (commonly
# 1024); stay well under it per syscall
_IOV_CHUNK = 256


class FrameError(OSError):
    """Corrupt or truncated wire frame (bad magic, lying lengths, bytes
    missing mid-message). An `OSError` on purpose: every pod recv loop
    already treats OSError as a dead connection."""


class PodAuthError(ConnectionError):
    """HMAC handshake failed — wrong or missing authkey."""


# ---------------------------------------------------------------------------
# encode


def encode_message(msg: dict) -> tuple[list, int]:
    """Message dict -> (scatter list of wire buffers, total bytes).

    The scatter list's first element is prelude+header; the rest are the
    payload buffers VIEWED IN PLACE (memoryviews into the caller's
    arrays — they must stay alive until the send completes, which the
    list itself guarantees). Non-contiguous arrays are made contiguous
    (the one copy this path cannot avoid); everything else ships
    zero-copy.
    """
    bufs: list = []
    descs: list[dict] = []

    def _add_nd(arr: np.ndarray) -> dict:
        arr = np.ascontiguousarray(arr)
        descs.append({"k": "nd", "d": arr.dtype.str,
                      "s": list(arr.shape), "n": int(arr.nbytes)})
        bufs.append(memoryview(arr).cast("B") if arr.nbytes else b"")
        return {"__buf__": len(bufs) - 1}

    def _default(obj):
        if isinstance(obj, np.ndarray):
            return _add_nd(obj)
        if isinstance(obj, (bytes, bytearray, memoryview)):
            data = obj if isinstance(obj, bytes) else bytes(obj)
            descs.append({"k": "bytes", "n": len(data)})
            bufs.append(data)
            return {"__buf__": len(bufs) - 1}
        if isinstance(obj, WorkerSnapshot):
            return {"__snap__": asdict(obj)}
        if isinstance(obj, np.generic):  # numpy scalar leaked into a field
            if isinstance(obj, np.bool_):
                return bool(obj)
            return int(obj) if isinstance(obj, np.integer) else float(obj)
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            # a host tensor rides as its numpy view (the same bytes); a
            # device tensor is the sender's to copy, never this encoder's
            if obj.device.type != "cpu":
                raise TypeError(
                    f"pod frames carry host arrays: a tensor on {obj.device} "
                    "reached the encoder (copy it to the host first)")
            if obj.dtype == torch.bfloat16:
                raise TypeError(
                    "pod frames carry numpy dtypes and bfloat16 has none: "
                    "convert the tensor (to float32) before framing")
            return _add_nd(obj.detach().numpy())
        if hasattr(obj, "__array__"):  # other array types: their host copy
            return _add_nd(np.asarray(obj))
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        descs.append({"k": "pkl", "n": len(data)})
        bufs.append(data)
        return {"__buf__": len(bufs) - 1}

    # key order is load-bearing: json.dumps renders "m" first (filling
    # descs via _default as it walks) and only then renders "b", so the
    # descriptor list is complete by the time it is serialized
    header = json.dumps({"m": msg, "b": descs}, default=_default,
                        separators=(",", ":")).encode("utf-8")
    if len(header) > MAX_HEADER_BYTES:
        raise FrameError(f"header {len(header)}B exceeds the "
                         f"{MAX_HEADER_BYTES}B cap")
    wire = [_PRELUDE.pack(MAGIC, len(header)) + header, *bufs]
    total = sum(len(b) for b in wire)
    return wire, total


# ---------------------------------------------------------------------------
# socket I/O


def send_buffers(sock: socket.socket, bufs: list) -> None:
    """Vectorized send of a scatter list (``sendmsg`` in IOV-sized
    chunks, partial sends advanced across the list)."""
    views = [memoryview(b) for b in bufs if len(b)]
    while views:
        sent = sock.sendmsg(views[:_IOV_CHUNK])
        while sent:
            head = views[0]
            if sent >= len(head):
                sent -= len(head)
                views.pop(0)
            else:
                views[0] = head[sent:]
                sent = 0


def recv_exact(sock: socket.socket, n: int, *,
               at_boundary: bool = False) -> bytes:
    """Read exactly ``n`` bytes. A clean close before the FIRST byte of
    a message (``at_boundary``) is `EOFError`; a close mid-read is a
    truncated frame — `FrameError`."""
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf), at_boundary=at_boundary)
    return bytes(buf)


def _recv_into(sock: socket.socket, view: memoryview, *,
               at_boundary: bool = False) -> None:
    first = at_boundary
    while len(view):
        n = sock.recv_into(view)
        if n == 0:
            if first:
                raise EOFError("connection closed")
            raise FrameError("connection closed mid-frame (truncated)")
        first = False
        view = view[n:]


def read_message(sock: socket.socket) -> tuple[dict, int]:
    """Read one framed message -> (decoded dict, total wire bytes).
    ndarray payloads land via ``recv_into`` directly in their final
    arrays."""
    prelude = recv_exact(sock, _PRELUDE.size, at_boundary=True)
    magic, hlen = _PRELUDE.unpack(prelude)
    if magic != MAGIC:
        raise FrameError(f"bad frame magic {magic!r}")
    if hlen > MAX_HEADER_BYTES:
        raise FrameError(f"header length {hlen}B exceeds the "
                         f"{MAX_HEADER_BYTES}B cap")
    try:
        header = json.loads(recv_exact(sock, hlen))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"undecodable frame header: {e}") from None
    total = _PRELUDE.size + hlen
    payloads: list = []
    for d in header.get("b", ()):
        kind, n = d.get("k"), int(d.get("n", 0))
        if kind == "nd":
            arr = np.empty(tuple(d["s"]), dtype=np.dtype(d["d"]))
            if arr.nbytes != n:
                raise FrameError(
                    f"array frame lies: shape {d['s']} x {d['d']} is "
                    f"{arr.nbytes}B, descriptor says {n}B")
            if n:
                _recv_into(sock, memoryview(arr).cast("B"))
            payloads.append(arr)
        elif kind == "bytes":
            payloads.append(recv_exact(sock, n))
        elif kind == "pkl":
            payloads.append(pickle.loads(recv_exact(sock, n)))
        else:
            raise FrameError(f"unknown buffer kind {kind!r}")
        total += n
    return _resolve(header.get("m"), payloads), total


def _resolve(node, payloads: list):
    """Rehydrate ``__buf__`` / ``__snap__`` placeholders in the decoded
    tree."""
    if isinstance(node, dict):
        if "__buf__" in node and len(node) == 1:
            return payloads[node["__buf__"]]
        if "__snap__" in node and len(node) == 1:
            return WorkerSnapshot(**node["__snap__"])
        return {k: _resolve(v, payloads) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, payloads) for v in node]
    return node


# ---------------------------------------------------------------------------
# handshake


def _mac(key: bytes, tag: bytes, nonce: bytes) -> bytes:
    return hmac.new(key, tag + nonce, "sha256").digest()


def server_handshake(sock: socket.socket, key: bytes) -> float:
    """Router side: challenge, verify the client's proof, prove back.
    Returns the challenge->proof round-trip in seconds (an RTT sample).
    Raises `PodAuthError` on a wrong key — the caller closes the socket
    and keeps listening."""
    nonce_s = os.urandom(_NONCE_LEN)
    t0 = time.perf_counter()
    send_buffers(sock, [_HS_MAGIC + bytes([_HS_VERSION]) + nonce_s])
    reply = recv_exact(sock, _MAC_LEN + _NONCE_LEN)
    rtt = time.perf_counter() - t0
    mac_c, nonce_c = reply[:_MAC_LEN], reply[_MAC_LEN:]
    if not hmac.compare_digest(mac_c, _mac(key, _CLIENT_TAG, nonce_s)):
        raise PodAuthError("client HMAC proof rejected (wrong authkey)")
    send_buffers(sock, [_mac(key, _SERVER_TAG, nonce_c)])
    return rtt


def client_handshake(sock: socket.socket, key: bytes) -> float:
    """Worker side: answer the server's challenge, counter-challenge,
    verify its proof. Returns the proof round-trip in seconds."""
    hello = recv_exact(sock, len(_HS_MAGIC) + 1 + _NONCE_LEN)
    if hello[:len(_HS_MAGIC)] != _HS_MAGIC:
        raise PodAuthError(f"not a pod transport endpoint "
                           f"(greeting {hello[:4]!r})")
    if hello[len(_HS_MAGIC)] != _HS_VERSION:
        raise PodAuthError(
            f"transport version mismatch (peer {hello[len(_HS_MAGIC)]}, "
            f"ours {_HS_VERSION})")
    nonce_s = hello[len(_HS_MAGIC) + 1:]
    nonce_c = os.urandom(_NONCE_LEN)
    t0 = time.perf_counter()
    send_buffers(
        sock, [_mac(key, _CLIENT_TAG, nonce_s) + nonce_c])
    try:
        mac_s = recv_exact(sock, _MAC_LEN)
    except (EOFError, FrameError):
        # server dropped us without proving back: rejected proof
        raise PodAuthError("server closed during handshake "
                           "(authkey rejected?)") from None
    rtt = time.perf_counter() - t0
    if not hmac.compare_digest(mac_s, _mac(key, _SERVER_TAG, nonce_c)):
        raise PodAuthError("server HMAC proof rejected (wrong authkey)")
    return rtt
