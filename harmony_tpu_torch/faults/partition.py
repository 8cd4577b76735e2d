"""Network-partition fault class: link rules over ``net.*`` sites.

Counterpart of ``harmony_tpu/faults/partition.py``, copied. In the port the
framed serving wire and the jobserver client consult these sites.

A real partition does not hand the caller a tidy exception at the
instant it starts — packets silently stop arriving, SYNs blackhole, and
the *absence* of traffic is what peers must detect. This module gives
the framed-wire paths (utils/framing.py), blockmove TCP, pod
HELLO/heartbeat, HA log replication, and the jobserver client two
injection points that model exactly that:

  * ``net.connect`` (ctx: ``role``, ``dst``) — consulted before every
    outbound ``socket.create_connection``. Rule actions map onto real
    link states: ``raise``/``skip`` = connection refused (the RST
    path), ``hang`` = a blackholed SYN (sleeps ``delay_sec`` then times
    out — exercising the caller's connect timeout for real), ``delay``
    = a slow link (sleep, then connect normally).
  * ``net.send`` (ctx: ``role``, ``dst``) — consulted before a framed
    write. ``skip`` silently drops the frame (the peer sees *silence*,
    not an error — lease expiry and heartbeat-miss detection fire),
    ``raise`` models a mid-stream RST, ``delay`` a congested link.

Asymmetric and partial partitions fall out of the rule matchers: a rule
matched on ``role="pod.report"`` severs follower->leader traffic while
leader->follower HELLOs still flow; matching ``dst`` cuts a single link
out of a full mesh. Healing is the rule's ``count`` running out —
deterministic, like every FaultPlan trigger.
"""
from __future__ import annotations

import socket
from typing import Optional, Tuple

from harmony_tpu_torch.faults import plan as faults


def _dst_str(addr: "Tuple[str, int] | str") -> str:
    if isinstance(addr, str):
        return addr
    try:
        host, port = addr[0], addr[1]
        return f"{host}:{port}"
    except Exception:
        return str(addr)


def fault_connect(addr: Tuple[str, int], *, role: str,
                  timeout: Optional[float] = None) -> socket.socket:
    """``socket.create_connection`` behind the ``net.connect`` site.

    Disarmed this is one global read plus the real connect. Armed, a
    matching rule turns the attempt into a refused / blackholed / slow
    link before any packet is sent.
    """
    if faults.armed():
        act = faults.site("net.connect", role=role, dst=_dst_str(addr))
        if act == "skip":
            raise ConnectionRefusedError(
                f"injected partition: connect refused [role={role} "
                f"dst={_dst_str(addr)}]")
        if act == "hang":
            # The sleep already happened inside site(); a blackholed SYN
            # surfaces to the caller as its connect timeout elapsing.
            raise socket.timeout(
                f"injected partition: connect blackholed [role={role} "
                f"dst={_dst_str(addr)}]")
    if timeout is None:
        return socket.create_connection(addr)
    return socket.create_connection(addr, timeout=timeout)


def frame_dropped(sock: socket.socket, *, role: str = "wire") -> bool:
    """Consult the ``net.send`` link rule for ``sock``'s peer. Returns
    True when the frame must be silently dropped (partition swallowing
    traffic); raises for mid-stream-reset rules; sleeps through
    ``delay`` rules. Callers guard with ``faults.armed()`` so the
    disarmed cost is zero.
    """
    try:
        dst = _dst_str(sock.getpeername())
    except OSError:
        dst = "?"
    act = faults.site("net.send", role=role, dst=dst)
    return act == "skip"
