"""Single-write framed-stream primitives shared by every TCP data plane.

Counterpart of ``harmony_tpu/utils/framing.py``, copied (the port keeps its
own copy of each jax-free module it needs), with one addition,
:func:`close_listener`. The serving wire (``serving/protocol.py``) rides
it. Two halves:

  * :func:`send_frame_parts` — one frame, ONE write: small payloads
    coalesce header+bodies into a single ``sendall`` buffer; large ones
    go through ``sendmsg``, the writev-style gather that submits the
    header and zero-copy payloads together, with a short-write tail
    loop. Two back-to-back sendall calls would put the tiny
    length-prefixed header in its own segment, which Nagle holds back
    waiting for the receiver's ACK of the previous frame's payload — a
    per-frame RTT stall (every sender also sets TCP_NODELAY).
  * :func:`read_exact` — exactly ``n`` bytes into ONE preallocated
    buffer via ``recv_into``; a ``bytearray += recv()`` loop copies
    every chunk twice (recv allocation + extend) and once more for a
    final ``bytes()``.
"""
from __future__ import annotations

import socket
from typing import Any, Optional, Sequence

#: Transport I/O chunk: the receiver's per-recv_into cap AND the
#: sender's head+bodies coalesce threshold share it, so both sides agree
#: on what "small enough to copy once" means.
IO_CHUNK = 1 << 20


def send_frame_parts(sock: socket.socket, head: bytes,
                     bodies: Sequence[Any], *, role: str = "wire") -> None:
    """Send ``head`` followed by each buffer of ``bodies``, in order, as
    ONE logical write (see module docstring). ``bodies`` elements are
    anything memoryview accepts (bytes / memoryview / buffer-protocol
    exporters).

    ``role`` labels this stream for the ``net.send`` partition site: an
    armed link rule can silently swallow the frame (the peer observes
    silence, not an error), reset it mid-stream, or slow it down.
    """
    from harmony_tpu_torch import faults

    if faults.armed():
        from harmony_tpu_torch.faults.partition import frame_dropped

        if frame_dropped(sock, role=role):
            return
    views = [b if isinstance(b, memoryview) else memoryview(b)
             for b in bodies]
    total = sum(len(v) for v in views)
    if total <= IO_CHUNK:
        sock.sendall(b"".join([head] + views))  # ONE copy, one syscall
        return
    parts = [memoryview(head)] + views
    try:
        sent = sock.sendmsg(parts)
    except AttributeError:  # pragma: no cover - platforms without sendmsg
        for p in parts:
            sock.sendall(p)
        return
    # sendmsg may stop short (socket buffer full): finish the remainder
    # with sendall, which loops internally
    for p in parts:
        if sent >= len(p):
            sent -= len(p)
            continue
        sock.sendall(p[sent:])
        sent = 0


def read_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """Exactly ``n`` bytes into ONE preallocated buffer via recv_into.
    Returns the buffer itself (callers frombuffer/parse it in place), or
    None on a clean EOF before the first byte / mid-read."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:got + min(IO_CHUNK, n - got)])
        if r == 0:
            return None
        got += r
    return buf


def set_nodelay(sock: socket.socket) -> None:
    """TCP_NODELAY on every framed stream — the header/payload frames
    are latency-sensitive and self-paced; Nagle only adds RTT stalls.
    Tolerates exotic transports without the option."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


def close_listener(sock: socket.socket) -> None:
    """Close a listening socket and wake the thread blocked in its
    ``accept``: on Linux a close alone leaves that thread in the kernel (the
    reference's serving ``stop`` then waits out a 5 s join); a shutdown
    first makes the ``accept`` fail at once."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass
