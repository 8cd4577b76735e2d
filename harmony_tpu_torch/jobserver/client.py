"""Client-side job submission over the TCP command endpoint.

Counterpart of ``harmony_tpu/jobserver/client.py``, copied (the reference's
CommandSender, jobserver/client/CommandSender.java:49-80): submit tools
connect to the long-running server by TCP and send SUBMIT with the
serialized job config, STATUS, WAIT, SERVING or SHUTDOWN. The wire format
is one newline-terminated JSON object each way, the same bytes as the
reference's, so either package's client talks to either package's server.

A client may hold a replica list (``HARMONY_JOBSERVER_ADDRS``,
comma-separated ``host:port``), retry across it with the standard bounded
backoff (faults/retry.py) and follow a ``NOT_LEADER`` reply's ``leader``
redirect: a standby replica (``jobserver/ha.py``) and a deposed leader
answer ``NOT_LEADER`` with the lease holder's address. A ``BUSY`` reply backs
off for its hint and retries the same server.
"""
from __future__ import annotations

import os
import json
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple

from harmony_tpu_torch.config.params import JobConfig

#: comma-separated replica submit endpoints (docs/DEPLOY.md §7) — the
#: client-side half of control-plane HA
ENV_ADDRS = "HARMONY_JOBSERVER_ADDRS"


def jobserver_addrs() -> List[str]:
    """The configured replica endpoint list (may be empty)."""
    raw = os.environ.get(ENV_ADDRS, "")
    return [a.strip() for a in raw.split(",") if a.strip()]


def _parse_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return (host or "127.0.0.1", int(port))


class NotLeaderError(RuntimeError):
    """The replica answered ``NOT_LEADER``; ``leader`` is its redirect
    hint (the lease holder's advertised address), or None."""

    def __init__(self, addr: str, leader: Optional[str]) -> None:
        super().__init__(f"{addr} is not the leader"
                         + (f" (leader: {leader})" if leader else ""))
        self.addr = addr
        self.leader = leader


class ServerBusyError(RuntimeError):
    """The leader answered a structured ``BUSY {retry_after_ms}``
    (admission control shed the command — jobserver/overload.py). A
    busy leader IS STILL THE LEADER: this error must never trigger
    failover to another replica (they would answer NOT_LEADER and the
    walk would land right back here); the client backs off for
    ``retry_after_ms`` (jittered) and retries the same endpoint."""

    def __init__(self, addr: str, retry_after_ms: int) -> None:
        super().__init__(
            f"{addr} is overloaded (BUSY, retry after {retry_after_ms}ms)")
        self.addr = addr
        self.retry_after_ms = int(retry_after_ms)


class CommandSender:
    """One logical client over one or many replicas.

    ``CommandSender(port)`` keeps the original single-endpoint shape;
    ``CommandSender(addrs=[...])`` (or :meth:`from_env`) enables
    failover: each roundtrip walks leader-hint-first through the
    replica list under the bounded retry policy, following NOT_LEADER
    redirects, until a replica accepts or the policy is exhausted."""

    def __init__(self, port: Optional[int] = None, host: str = "127.0.0.1",
                 timeout: float = 60.0,
                 addrs: Optional[Sequence[str]] = None) -> None:
        if port is None and not addrs:
            raise ValueError("CommandSender needs a port or an addr list")
        self.host = host
        self.port = port
        self.timeout = timeout
        self.addrs: List[str] = list(addrs or [])
        if port is not None and not self.addrs:
            self.addrs = [f"{host}:{port}"]
        #: the replica that last answered as leader — tried first
        self._leader_hint: Optional[str] = None

    @classmethod
    def from_env(cls, port: Optional[int] = None,
                 timeout: float = 60.0) -> "CommandSender":
        """HARMONY_JOBSERVER_ADDRS when set, else the given (or
        default 43110) local port."""
        addrs = jobserver_addrs()
        if addrs:
            return cls(addrs=addrs, timeout=timeout)
        return cls(port if port is not None else 43110, timeout=timeout)

    # -- wire ------------------------------------------------------------

    def _roundtrip_one(self, addr: str,
                       payload: Dict[str, Any]) -> Dict[str, Any]:
        from harmony_tpu_torch.faults.partition import fault_connect

        with fault_connect(_parse_addr(addr), role="client",
                           timeout=self.timeout) as s:
            s.sendall((json.dumps(payload) + "\n").encode())
            data = b""
            while not data.endswith(b"\n"):
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
        if not data.strip():
            raise RuntimeError(
                f"empty reply from job server at {addr} "
                "(connection closed without a response)"
            )
        reply = json.loads(data.decode())
        if isinstance(reply, dict) and reply.get("not_leader"):
            raise NotLeaderError(addr, reply.get("leader"))
        if isinstance(reply, dict) and reply.get("busy"):
            # the busy replica answered authoritatively — remember it
            # as the leader so the backoff retry goes straight back
            self._leader_hint = addr
            raise ServerBusyError(addr,
                                  int(reply.get("retry_after_ms", 250)))
        return reply

    def _candidates(self) -> List[str]:
        """Replicas in try order: last-known leader first, then the
        configured list (stable order; duplicates removed)."""
        out: List[str] = []
        for a in ([self._leader_hint] if self._leader_hint else []) + \
                self.addrs:
            if a and a not in out:
                out.append(a)
        return out

    def _roundtrip_route(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """One command against the replica set: every retry attempt
        walks the candidate list (following at most one NOT_LEADER
        redirect per walk); connection failures and standby replies
        back off under the standard bounded policy — a takeover window
        is exactly the transient the retry idiom exists for.

        A :class:`ServerBusyError` ABORTS the walk immediately (it is
        not retryable here): the replica that answered BUSY holds the
        lease, so trying the others would only collect NOT_LEADERs.
        The busy backoff lives one layer up (:meth:`_roundtrip`)."""
        from harmony_tpu_torch.config.params import RetryPolicy
        from harmony_tpu_torch.faults.retry import call_with_retry

        def attempt() -> Dict[str, Any]:
            last: Optional[BaseException] = None
            for addr in self._candidates():
                try:
                    reply = self._roundtrip_one(addr, payload)
                    self._leader_hint = addr
                    return reply
                except NotLeaderError as e:
                    last = e
                    if e.leader and e.leader not in (addr,):
                        try:
                            reply = self._roundtrip_one(e.leader, payload)
                            self._leader_hint = e.leader
                            return reply
                        except (OSError, NotLeaderError,
                                ValueError) as e2:
                            last = e2
                except (OSError, ValueError) as e:
                    last = e
            raise ConnectionError(
                f"no jobserver replica accepted {payload.get('command')}: "
                f"{type(last).__name__ if last else '?'}: {last}")

        if self.port is not None and len(self.addrs) <= 1:
            # legacy single fixed endpoint (port ctor): keep the
            # original fail-fast shape — tests and scripts rely on an
            # immediate refused/NOT_LEADER error, on EVERY command of
            # the sender's lifetime. An ``addrs`` ctor of any length
            # opts into failover + redirect following.
            return self._roundtrip_one(self.addrs[0], payload)
        return call_with_retry(
            attempt, RetryPolicy.from_env(), op="client.roundtrip",
            retryable=(ConnectionError,),
        )

    def _roundtrip(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """The busy-honoring roundtrip: BUSY {retry_after_ms} replies
        back off (the server's hint is the floor under the policy's
        jittered schedule) and retry the SAME leader — never failover;
        failover stays reserved for CONNECT errors inside
        :meth:`_roundtrip_route`. Bounded by the standard retry
        policy: a persistently-overloaded control plane surfaces as a
        RetryError instead of an infinite client spin."""
        import time as _time

        from harmony_tpu_torch.config.params import RetryPolicy
        from harmony_tpu_torch.faults.retry import call_with_retry, jitter_rng

        policy = RetryPolicy.from_env()
        hint_ms = [0]

        def once() -> Dict[str, Any]:
            try:
                return self._roundtrip_route(payload)
            except ServerBusyError as e:
                hint_ms[0] = e.retry_after_ms
                raise

        def pause(delay: float) -> None:
            # jitter_rng: the swappable source faults.retry uses for its
            # own backoff, so a seeded chaos replay pins BOTH schedules
            floor = (hint_ms[0] / 1000.0) * (
                1.0 + policy.jitter * jitter_rng().random())
            _time.sleep(max(delay, floor))

        return call_with_retry(
            once, policy, op="client.busy",
            retryable=(ServerBusyError,), sleep=pause,
        )

    # -- commands --------------------------------------------------------

    def send_job_submit_command(self, config: JobConfig) -> Dict[str, Any]:
        """SUBMIT carries the caller's span context beside the config (the
        TraceInfo-in-the-message pattern, tracing/span.py): a submission
        made inside ``trace_span("cli.submit")`` yields ONE trace_id from
        this client through the jobserver's dispatch, the pod legs and
        the remote workers' spans. None outside any span — the field is
        simply absent and the server roots a fresh trace."""
        from harmony_tpu_torch.tracing.span import wire_context

        msg: Dict[str, Any] = {"command": "SUBMIT", "conf": config.to_dict()}
        wire = wire_context()
        if wire is not None:
            msg["trace"] = wire
        return self._roundtrip(msg)

    def send_status_command(self) -> Dict[str, Any]:
        return self._roundtrip({"command": "STATUS"})

    def send_wait_command(self, job_id: str,
                          timeout: float = 30.0) -> Dict[str, Any]:
        """One bounded WAIT poll on a submission's result."""
        return self._roundtrip({"command": "WAIT", "job_id": job_id,
                                "timeout": timeout})

    def wait_result(self, job_id: str, timeout: float = 300.0,
                    poll: float = 15.0) -> Dict[str, Any]:
        """Follow ONE submission to completion across replicas: WAIT
        polls ride the failover roundtrip, so a leader change mid-job
        redirects to the successor — which re-armed the same submission
        from the durable log and resolves it under the same job id.
        Returns the result dict; raises on job failure or deadline."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while True:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"job {job_id} did not complete within {timeout}s")
            try:
                reply = self.send_wait_command(
                    job_id, timeout=min(poll, max(0.5, remaining)))
            except (ConnectionError, RuntimeError):
                # takeover window (no leader yet) — keep polling until
                # the deadline; the retry policy already backed off
                _time.sleep(min(1.0, max(0.0, remaining)))
                continue
            if reply.get("ok") and reply.get("done"):
                return reply.get("result") or {}
            if not reply.get("ok"):
                if not reply.get("known", True):
                    # the successor may still be replaying/re-arming —
                    # an unknown id right after failover is transient
                    _time.sleep(min(1.0, max(0.0, remaining)))
                    continue
                raise RuntimeError(
                    f"job {job_id} failed: {reply.get('error')}")

    def send_pod_reshard_command(
        self, job_id: str, src: str, dst: str, num_blocks: int, epoch: int
    ) -> Dict[str, Any]:
        """Operator-initiated live migration of a running pod job (the
        reference's master-side moveBlocks, reachable from ops tooling)."""
        return self._roundtrip({
            "command": "POD_RESHARD", "job_id": job_id, "src": src,
            "dst": dst, "num_blocks": num_blocks, "epoch": epoch,
        })

    def send_serving_command(self) -> Dict[str, Any]:
        """Resolve (and start on demand) the leader's serving endpoint
        (harmony_tpu/serving): leader-gated server-side, so the reply's
        ``host:port`` always names the replica that owns live tables."""
        return self._roundtrip({"command": "SERVING"})

    def send_shutdown_command(self) -> Dict[str, Any]:
        return self._roundtrip({"command": "SHUTDOWN"})


def submit_job(config: JobConfig, port: int) -> Dict[str, Any]:
    reply = CommandSender(port).send_job_submit_command(config)
    if not reply.get("ok"):
        raise RuntimeError(f"submit failed: {reply.get('error')}")
    return reply


def shutdown_server(port: int) -> None:
    CommandSender(port).send_shutdown_command()
