"""Framed-TCP channel + listener for the pod tier.

`NetChannel` is a drop-in for `protocol.Channel` — same
``send(dict)`` / ``recv()`` / ``close()`` / ``closed`` surface, same
threading contract (send from any thread behind a lock, recv owned by
exactly one receiver thread) — but speaking the `pod.transport` framing
instead of pickle: array payloads go to the socket straight from their
own memory and arrive via ``recv_into``, with ``TCP_NODELAY`` set so a
submit is one write, not one write plus a Nagle stall.

Sends are *pipelined*: ``send`` returns once the kernel has the bytes;
nothing waits for an application-level ack (results, health replies,
and byes all flow back asynchronously through the peer's own sends).
The router layers heartbeat *coalescing* on top — at most one
unanswered health probe per worker in flight — so a worker busy with a
batch sees one probe to answer when it surfaces, not a backlog of
stale ones (`PodRouter._heartbeat_loop`).

`NetListener` owns the accepting socket and the connection registry
(every accepted channel, for teardown and accounting); the HMAC
handshake (`transport.server_handshake`) runs inside ``accept`` under
a timeout, and a failed handshake is COUNTED and dropped — the
listener keeps listening, one bad client cannot wedge the pod.

Addresses carry their scheme: ``tcp://host:port`` dials this module,
a bare ``host:port`` stays on the legacy multiprocessing pipe — which
is how one ``--connect`` argv plumbs transport selection through to
workers with zero extra flags.
"""

from __future__ import annotations

import socket
import threading

from wam_tpu_torch.obs.registry import registry as _obs_registry
from wam_tpu_torch.pod.transport import (
    HANDSHAKE_TIMEOUT_S,
    FrameError,
    PodAuthError,
    client_handshake,
    encode_message,
    read_message,
    send_buffers,
    server_handshake,
)

__all__ = [
    "NetChannel",
    "NetListener",
    "TCP_SCHEME",
    "connect_tcp",
    "format_address",
    "parse_address",
]

TCP_SCHEME = "tcp://"

_c_tx_bytes = _obs_registry.counter(
    "wam_tpu_pod_net_tx_bytes_total",
    "bytes written to pod transport sockets (framing included)")
_c_rx_bytes = _obs_registry.counter(
    "wam_tpu_pod_net_rx_bytes_total",
    "bytes read from pod transport sockets (framing included)")
_c_messages = _obs_registry.counter(
    "wam_tpu_pod_net_messages_total", "framed messages moved",
    labels=("direction",))
_c_handshakes = _obs_registry.counter(
    "wam_tpu_pod_net_handshakes_total", "transport HMAC handshakes",
    labels=("outcome",))


def format_address(host: str, port: int) -> str:
    return f"{TCP_SCHEME}{host}:{port}"


def parse_address(address: str) -> tuple[str, int]:
    """``tcp://host:port`` -> (host, port)."""
    hostport = address[len(TCP_SCHEME):] if address.startswith(TCP_SCHEME) \
        else address
    host, _, port = hostport.rpartition(":")
    return host or "127.0.0.1", int(port)


class NetChannel:
    """One authenticated framed-TCP connection. See module docstring
    for the threading contract."""

    # lock-discipline: send-path state is mutated under the send lock
    # (send() races close() and the router's heartbeat thread)
    _GUARDED_BY = {
        "_closed": "_send_lock",
        "tx_bytes": "_send_lock",
        "tx_messages": "_send_lock",
    }

    def __init__(self, sock: socket.socket, *, peer: str = "",
                 handshake_rtt_s: float | None = None):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._send_lock = threading.Lock()
        self._closed = False
        self.peer = peer
        # one free RTT sample from the HMAC proof round-trip — the
        # router seeds its per-host RTT EMA with it pre-first-heartbeat
        self.handshake_rtt_s = handshake_rtt_s
        self.tx_bytes = 0
        self.tx_messages = 0
        # rx accounting belongs to the single receiver thread; no lock
        self.rx_bytes = 0
        self.rx_messages = 0

    def send(self, msg: dict) -> None:
        bufs, total = encode_message(msg)
        with self._send_lock:
            if self._closed:
                raise OSError("pod net channel is closed")
            send_buffers(self._sock, bufs)
            self.tx_bytes += total
            self.tx_messages += 1
        _c_tx_bytes.inc(total)
        _c_messages.inc(direction="tx")

    def recv(self) -> dict:
        msg, total = read_message(self._sock)
        self.rx_bytes += total
        self.rx_messages += 1
        _c_rx_bytes.inc(total)
        _c_messages.inc(direction="rx")
        return msg

    def close(self) -> None:
        with self._send_lock:
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def closed(self) -> bool:
        return self._closed


class NetListener:
    """Accepting socket + connection registry for the router side.

    ``accept()`` blocks until one connection SURVIVES the HMAC
    handshake (failed attempts are counted in ``bad_handshakes`` and
    the ``wam_tpu_pod_net_handshakes_total`` counter, then dropped);
    it raises OSError once the listener is closed — the same contract
    `multiprocessing.connection.Listener` gives the router's accept
    loop."""

    # lock-discipline: the connection registry is appended by accept()
    # and drained by close(), potentially on different threads
    _GUARDED_BY = {
        "_conns": "_lock",
        "_closed": "_lock",
        "bad_handshakes": "_lock",
    }

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 authkey: bytes):
        self._authkey = authkey
        self._lock = threading.Lock()
        self._conns: list[NetChannel] = []
        self._closed = False
        self.bad_handshakes = 0
        self._sock = socket.create_server((host, port), backlog=64)
        h, p = self._sock.getsockname()[:2]
        self.address = (h, p)

    def accept(self) -> NetChannel:
        while True:
            sock, addr = self._sock.accept()  # OSError once closed
            sock.settimeout(HANDSHAKE_TIMEOUT_S)
            try:
                rtt = server_handshake(sock, self._authkey)
            except (PodAuthError, FrameError, EOFError, OSError):
                _c_handshakes.inc(outcome="rejected")
                with self._lock:
                    self.bad_handshakes += 1
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            sock.settimeout(None)
            _c_handshakes.inc(outcome="ok")
            ch = NetChannel(sock, peer=f"{addr[0]}:{addr[1]}",
                            handshake_rtt_s=rtt)
            with self._lock:
                if self._closed:
                    ch.close()
                    raise OSError("pod net listener is closed")
                self._conns.append(ch)
            return ch

    def connections(self) -> list[NetChannel]:
        with self._lock:
            return list(self._conns)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            # wakes a thread blocked in accept(), which close() alone does not
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def connect_tcp(address: str, authkey: bytes) -> NetChannel:
    """Worker-side dial of a ``tcp://host:port`` router endpoint:
    connect, prove the authkey, return the framed channel."""
    host, port = parse_address(address)
    sock = socket.create_connection((host, port),
                                    timeout=HANDSHAKE_TIMEOUT_S)
    try:
        rtt = client_handshake(sock, authkey)
    except BaseException:
        try:
            sock.close()
        except OSError:
            pass
        raise
    sock.settimeout(None)
    _c_handshakes.inc(outcome="ok")
    return NetChannel(sock, peer=address, handshake_rtt_s=rtt)
