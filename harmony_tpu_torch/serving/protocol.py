"""Serving wire protocol: framed JSON headers + zero-copy key/row arrays.

Counterpart of ``harmony_tpu/serving/protocol.py``, copied: for the same
message the two packages put the same bytes on the wire.

Rides the SAME single-write framed-stream discipline as the input
service and the block-migration transport (utils/framing.py): every
frame is a 4-byte little-endian header length, a JSON header, and zero
or more payload buffers submitted in ONE write (coalesced small,
sendmsg-gathered large); both socket ends set TCP_NODELAY. A lookup is
latency-bound, not bandwidth-bound — the single-write rule is what
keeps a request from paying a Nagle RTT stall per frame.

Frame kinds, distinguished by the header's ``op``:

  * ``lookup`` — ``{"op": "lookup", "r": <id>, "job": ..., "mode":
    "live"|"pinned"}`` plus ONE int key array payload;
  * ``rows`` — the reply: request id echoed, consistency metadata
    (``mode``, ``layout_version`` for live, ``epoch``/``chkp`` for
    pinned) and ONE row array payload;
  * ``busy`` — admission control shed the request
    (``{"retry_after_ms": ...}``, jobserver/overload.py semantics);
  * control — header-only (``ping``/``pong``/``stats``/``error``).

The decoder returns array payloads as numpy views over the received
buffer — zero extra copies after the socket read — and raises
:class:`ProtocolError` (an OSError) on EVERY decode failure so client
retry/fallback paths need exactly one except clause.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from harmony_tpu_torch.utils.framing import read_exact, send_frame_parts, set_nodelay

__all__ = [
    "ProtocolError",
    "connect",
    "recv_frame",
    "send_arrays",
    "send_msg",
]

#: Bound on one frame's JSON header — a frame whose header length field
#: exceeds this is a desynced/hostile stream, not a big request.
_MAX_HEADER = 1 << 20

#: Bound on one array payload — a parseable-but-garbage header claiming
#: petabytes must raise a retryable ProtocolError, not OOM the server
#: inside ``bytearray(n)``.
_MAX_PAYLOAD = 4 << 30


class ProtocolError(OSError):
    """Framing violation (truncated/desynced stream)."""


def connect(addr: Tuple[str, int], timeout: float = 10.0) -> socket.socket:
    from harmony_tpu_torch.faults.partition import fault_connect

    sock = fault_connect(addr, role="serving", timeout=timeout)
    set_nodelay(sock)
    return sock


def _head(header: Dict[str, Any]) -> bytes:
    raw = json.dumps(header, separators=(",", ":")).encode()
    return struct.pack("<I", len(raw)) + raw


def send_msg(sock: socket.socket, header: Dict[str, Any]) -> None:
    """One control frame (header only), one write."""
    send_frame_parts(sock, _head(header), (), role="serving")


def _array_meta(arr: np.ndarray) -> Tuple[Dict[str, Any], Any]:
    payload = np.ascontiguousarray(arr)
    dt = payload.dtype
    meta = {
        "dtype": dt.name if dt.kind == "V" else dt.str,
        "shape": list(payload.shape),
        "n": int(payload.nbytes),
    }
    try:
        body: Any = memoryview(payload).cast("B")
    except (TypeError, ValueError):
        body = payload.tobytes()  # extension dtypes without buffer protocol
    return meta, body


def send_arrays(sock: socket.socket, header: Dict[str, Any],
                arrays: Sequence[np.ndarray]) -> None:
    """One frame carrying ``header`` + every array, ONE write: the
    metadata rides the header's ``arrays`` list, the bytes go through
    the shared coalesce/sendmsg gather path."""
    metas = []
    bodies = []
    for a in arrays:
        meta, body = _array_meta(np.asarray(a))
        metas.append(meta)
        bodies.append(body)
    head = _head({**header, "arrays": metas})
    send_frame_parts(sock, head, bodies, role="serving")


def recv_frame(sock: socket.socket) -> Optional[Dict[str, Any]]:
    """Next frame as its header dict; frames with an ``arrays`` list
    carry the decoded numpy arrays under ``"data"`` (a tuple). None on
    clean EOF before a header; ProtocolError on truncation mid-frame."""
    raw = read_exact(sock, 4)
    if raw is None:
        return None
    (hlen,) = struct.unpack("<I", raw)
    if hlen > _MAX_HEADER:
        raise ProtocolError(f"oversized frame header ({hlen} bytes)")
    hraw = read_exact(sock, hlen)
    if hraw is None:
        raise ProtocolError("truncated frame header")
    try:
        header = json.loads(bytes(hraw))
    except ValueError as e:
        raise ProtocolError(f"unparseable frame header: {e}") from e
    if "arrays" not in header:
        return header
    data = []
    for meta in header.get("arrays", ()):
        try:
            n = int(meta["n"])
            dt = np.dtype(meta["dtype"])
            shape = tuple(int(d) for d in meta["shape"])
        except (KeyError, TypeError, ValueError) as e:
            raise ProtocolError(
                f"bad {header.get('op')} array header: {e}") from e
        if not 0 <= n <= _MAX_PAYLOAD:
            raise ProtocolError(
                f"{header.get('op')} frame claims a {n}-byte array "
                "(desynced stream)")
        expected = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        if n != expected:
            raise ProtocolError(
                f"{header.get('op')} payload size {n} != {expected} "
                f"for shape {shape} {dt} (desynced stream)")
        body = read_exact(sock, n)
        if body is None:
            raise ProtocolError(
                f"truncated {header.get('op')} payload")
        # every decode failure must be ProtocolError (an OSError): the
        # client's failover-and-retry only catches OSError, and the
        # serving plane must never wedge a reader on a garbled frame
        try:
            data.append(np.frombuffer(body, dtype=dt).reshape(shape))
        except (TypeError, ValueError) as e:
            raise ProtocolError(
                f"undecodable {header.get('op')} payload: {e}") from e
    header["data"] = tuple(data)
    return header
