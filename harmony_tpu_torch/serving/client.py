"""Serving client: framed lookups through a discovered serving endpoint.

Counterpart of ``harmony_tpu/serving/client.py``, copied. The data plane
(serving/protocol.py frames) is reached through the control plane: the
client first asks the jobserver's command endpoint for the serving port
(the ``SERVING`` command, which starts the endpoint on demand) through the
same ``CommandSender`` every other client command uses, with its replica
list when one is given (``HARMONY_JOBSERVER_ADDRS``).

On a dead or desynced stream the client drops its connection and resolves
again; structured ``busy`` frames (admission control shed the lookup) back
off for the server's hinted interval, jittered through the shared
``jitter_rng`` so seeded fault replays pin the schedule, and retry, bounded
by the caller's deadline.
"""
from __future__ import annotations

import itertools
import socket
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from harmony_tpu_torch.jobserver.client import CommandSender
from harmony_tpu_torch.serving import protocol

__all__ = ["ServingClient", "ServingUnavailableError"]


class ServingUnavailableError(ConnectionError):
    """No replica produced a serving endpoint within the deadline."""


class ServingClient:
    """One reader over one (possibly replicated) jobserver.

    ``ServingClient(port=...)`` keeps the single-endpoint shape;
    ``ServingClient(addrs=[...])`` / :meth:`from_env` enables failover.
    """

    def __init__(self, port: Optional[int] = None,
                 addrs: Optional[Sequence[str]] = None,
                 timeout: float = 10.0) -> None:
        self._sender = CommandSender(port=port, addrs=addrs,
                                     timeout=timeout)
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._rid = itertools.count(1)

    @classmethod
    def from_env(cls, port: Optional[int] = None,
                 timeout: float = 10.0) -> "ServingClient":
        """HARMONY_JOBSERVER_ADDRS when set, else the given (or default
        43110) local port — the same resolution as CommandSender."""
        c = cls(port=port if port is not None else 43110, timeout=timeout)
        c._sender = CommandSender.from_env(port=port, timeout=timeout)
        return c

    # -- connection management -------------------------------------------

    def _resolve(self) -> Tuple[str, int]:
        """The current leader's serving endpoint (starting it on demand
        server-side); rides the failover roundtrip."""
        reply = self._sender.send_serving_command()
        if not reply.get("ok") or not reply.get("port"):
            raise ConnectionError(
                f"no serving endpoint: {reply.get('error', reply)}")
        return (str(reply.get("host") or "127.0.0.1"), int(reply["port"]))

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = protocol.connect(self._resolve(),
                                          timeout=self.timeout)
        return self._sock

    def _drop(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        self._drop()

    # -- requests ---------------------------------------------------------

    def lookup(self, job: str, keys: Any, mode: str = "live",
               timeout: Optional[float] = None
               ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Rows for ``keys`` -> ``(rows, meta)``; meta carries the read
        mode's consistency fields (``layout_version`` live,
        ``epoch``/``chkp`` pinned). Retries across connection loss
        (re-resolving the leader) and busy sheds until ``timeout``."""
        from harmony_tpu_torch.faults.retry import jitter_rng

        keys = np.ascontiguousarray(np.asarray(keys, dtype=np.int32))
        deadline = time.monotonic() + (self.timeout if timeout is None
                                       else timeout)
        last: Optional[BaseException] = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ServingUnavailableError(
                    f"lookup({job!r}) exhausted its deadline: "
                    f"{type(last).__name__ if last else 'timeout'}: {last}")
            rid = next(self._rid)
            try:
                sock = self._conn()
                protocol.send_arrays(
                    sock, {"op": "lookup", "r": rid, "job": job,
                           "mode": mode}, (keys,))
                reply = protocol.recv_frame(sock)
            except (OSError, RuntimeError, ValueError) as e:
                # dead/desynced stream OR no leader yet (takeover
                # window): drop and re-resolve until the deadline
                last = e
                self._drop()
                time.sleep(min(0.2, max(0.0, remaining)))
                continue
            if reply is None:
                last = ConnectionError("serving stream closed")
                self._drop()
                continue
            op = reply.get("op")
            if op == "busy":
                # the endpoint is authoritative but shedding: honor its
                # hint (jittered floor), never failover on busy
                hint = int(reply.get("retry_after_ms", 100)) / 1000.0
                time.sleep(min(max(0.0, remaining),
                               hint * (1.0 + 0.2 * jitter_rng().random())))
                last = ConnectionError("serving busy")
                continue
            if op == "rows":
                data = reply.get("data") or ()
                if len(data) != 1 or int(reply.get("r", -1)) != rid:
                    last = protocol.ProtocolError(
                        "mismatched serving response")
                    self._drop()
                    continue
                meta = {k: v for k, v in reply.items()
                        if k not in ("op", "r", "arrays", "data")}
                return data[0], meta
            raise RuntimeError(
                f"lookup({job!r}) failed: {reply.get('error', reply)}")

    def stats(self) -> Dict[str, Any]:
        sock = self._conn()
        protocol.send_msg(sock, {"op": "stats"})
        reply = protocol.recv_frame(sock)
        if not reply or reply.get("op") != "stats":
            raise protocol.ProtocolError("bad stats reply")
        return reply.get("stats") or {}

    def ping(self) -> bool:
        try:
            sock = self._conn()
            protocol.send_msg(sock, {"op": "ping"})
            reply = protocol.recv_frame(sock)
            return bool(reply and reply.get("op") == "pong")
        except OSError:
            self._drop()
            return False
