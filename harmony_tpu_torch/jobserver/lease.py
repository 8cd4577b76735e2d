"""Leader election by lease: file-based, fenced by monotonic epochs.

Counterpart of ``harmony_tpu/jobserver/lease.py``, copied. The control
plane's replicas elect a leader by contending on ONE lease file under the
shared HA directory (``HARMONY_HA_LOG_DIR``). The protocol is the classic
expiring lease:

  * ``try_acquire``: under an exclusive file lock, read the current lease;
    if a LIVE peer holds it (now < expires) the attempt fails; otherwise
    write a fresh lease with ``epoch = old + 1``, the monotonic **leader
    epoch** that fences a deposed leader's late writes downstream (the
    durable log, RUN_JOB and PLAN messages, replication).
  * ``renew``: the holder rewrites ``expires`` every ``lease_s / 3``
    seconds from a daemon thread. A renewal that finds the lease held by
    someone else (or at another epoch) means THIS process was deposed:
    ``on_lost`` fires and the manager goes invalid, so the server stops
    accepting writes (NOT_LEADER) rather than split-braining.
  * ``is_valid``: purely local, true while the last successful acquire or
    renewal is younger than the lease. A leader that cannot reach the
    lease file for a lease window considers ITSELF deposed, successor or
    not.

Every write of the lease file is fsync'd, and the first one (which creates
the file) also syncs its directory (``utils/durability.py``). The fault
sites keep the reference's names and keys: ``disk.read`` and
``disk.write`` with ``kind="lease"``, and ``jobserver.lease_renew`` on
every renewal (a ``skip`` rule models a wedged leader whose lease silently
runs out).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from harmony_tpu_torch.jobserver.joblog import server_log
from harmony_tpu_torch.utils.durability import fsync_dir

#: the operational knobs
ENV_LOG_DIR = "HARMONY_HA_LOG_DIR"
ENV_LEASE_S = "HARMONY_HA_LEASE_S"
ENV_REPLICAS = "HARMONY_HA_REPLICAS"

LEASE_FILENAME = "leader.lease"


def ha_log_dir() -> Optional[str]:
    """The HA state directory, or None when HA is off."""
    return os.environ.get(ENV_LOG_DIR) or None


def lease_seconds() -> float:
    try:
        return float(os.environ.get(ENV_LEASE_S, "10"))
    except ValueError:
        return 10.0


def replica_peers() -> List[str]:
    """``HARMONY_HA_REPLICAS``: comma-separated standby log-receiver
    endpoints (``host:port``) the leader streams the durable log to. Empty
    when the replicas share ``HARMONY_HA_LOG_DIR`` instead."""
    raw = os.environ.get(ENV_REPLICAS, "")
    return [p.strip() for p in raw.split(",") if p.strip()]


def read_lease(log_dir: str) -> Optional[Dict[str, Any]]:
    """The current lease file (None when absent or unparseable): the helper
    behind every leader-hint lookup."""
    from harmony_tpu_torch import faults

    if faults.armed():
        # "skip" models a store whose directory entry never became visible;
        # an injected EIO lands where a sick disk's would
        try:
            if faults.site("disk.read", kind="lease") == "skip":
                return None
        except OSError:
            return None
    try:
        with open(os.path.join(log_dir, LEASE_FILENAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def leader_hint(log_dir: str, own_holder_id: Optional[str] = None) -> Optional[str]:
    """The LIVE leader's advertised submit address from the lease file, or
    None (expired, missing, or held by ``own_holder_id`` itself)."""
    cur = read_lease(log_dir)
    if not cur or time.time() >= float(cur.get("expires", 0.0)):
        return None
    if own_holder_id is not None and cur.get("holder") == own_holder_id:
        return None
    return cur.get("addr")


class LeaseManager:
    """One replica's handle on the shared leader lease (module doc)."""

    def __init__(self, log_dir: str, holder_id: str, lease_s: Optional[float] = None,
                 on_lost: Optional[Callable[[], None]] = None,
                 addr: Optional[str] = None) -> None:
        self.path = os.path.join(log_dir, LEASE_FILENAME)
        self.holder_id = holder_id
        #: the submit endpoint this holder advertises in the lease file: the
        #: redirect target of the standbys' NOT_LEADER replies
        self.addr = addr
        self.lease_s = float(lease_s if lease_s is not None else lease_seconds())
        self._on_lost = on_lost
        #: the lease the LAST successful acquire read before overwriting it
        #: (whom the takeover succeeded)
        self.previous: Optional[Dict[str, Any]] = None
        self._lock = threading.Lock()
        self.epoch = 0
        self._held = False
        #: monotonic stamp of the last successful acquire or renewal
        self._renewed_mono = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.renewals = 0
        self.renew_failures = 0
        os.makedirs(log_dir, exist_ok=True)

    # -- the shared file ---------------------------------------------------

    def _locked(self, fn):
        """``fn()`` under the cross-process lease lock (flock on a sibling
        ``.lock`` file)."""
        import fcntl

        with open(self.path + ".lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                return fn()
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)

    def _read(self) -> Optional[Dict[str, Any]]:
        return read_lease(os.path.dirname(self.path))

    def _write(self, lease: Dict[str, Any]) -> None:
        from harmony_tpu_torch import faults

        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            # ENOSPC/EIO raise (try_acquire treats the store as unreachable),
            # "delay" is a slow shared mount, "skip" drops the fsync
            act = (faults.site("disk.write", kind="lease", holder=self.holder_id)
                   if faults.armed() else None)
            json.dump(lease, f)
            f.flush()
            if act != "skip":
                os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- the protocol --------------------------------------------------------

    def try_acquire(self) -> bool:
        """One election attempt; True iff this replica now holds the lease
        (the epoch bumped when taken over from another holder)."""

        def attempt() -> bool:
            cur = self._read()
            now = time.time()
            if (cur and cur.get("holder") != self.holder_id
                    and now < float(cur.get("expires", 0.0))):
                return False  # a live peer holds it
            prev_epoch = int(cur.get("epoch", 0)) if cur else 0
            same = bool(cur) and cur.get("holder") == self.holder_id
            epoch = prev_epoch if same else prev_epoch + 1
            self._write({"holder": self.holder_id, "epoch": epoch, "addr": self.addr,
                         "expires": now + self.lease_s, "acquired": now})
            if cur is None:
                # the first acquire CREATED the file: its directory entry is
                # durable only once the directory is synced, or a host crash
                # could mint epoch 1 twice
                fsync_dir(self.path)
            if not same:
                self.previous = cur
            with self._lock:
                self.epoch = epoch
                self._held = True
                self._renewed_mono = time.monotonic()
            return True

        try:
            return bool(self._locked(attempt))
        except OSError:
            # a sick lease store: this attempt fails, and wait_acquire keeps
            # polling until the store heals
            return False

    def wait_acquire(self, timeout: Optional[float] = None,
                     poll: Optional[float] = None) -> bool:
        """Block until the lease is acquired (or ``timeout``). Polls at a
        fraction of the lease, so a takeover lands within one lease window
        of the old leader's death."""
        poll = poll if poll is not None else max(0.05, self.lease_s / 5.0)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.try_acquire():
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            if self._stop.wait(poll):
                return False

    def renew(self) -> bool:
        """One renewal; False (and ``on_lost``) when deposed."""
        from harmony_tpu_torch import faults

        if faults.armed():
            # "skip": a wedged leader whose renewals stop, so the lease runs
            # out and a standby takes over. The renewal thread survives any
            # injected action.
            try:
                if faults.site("jobserver.lease_renew", holder=self.holder_id,
                               epoch=self.epoch) == "skip":
                    return self.is_valid()
            except Exception:  # noqa: BLE001 - the thread lives on
                return self.is_valid()

        with self._lock:
            if not self._held:
                return False  # released or deposed: never re-extend

        def attempt() -> bool:
            cur = self._read()
            if (not cur or cur.get("holder") != self.holder_id
                    or int(cur.get("epoch", 0)) != self.epoch or cur.get("released")):
                # deposed, or release() already handed the lease off: a
                # renewal racing the release must not re-extend it
                return False
            now = time.time()
            self._write(dict(cur, expires=now + self.lease_s, renewed=now))
            with self._lock:
                self._renewed_mono = time.monotonic()
            return True

        try:
            ok = bool(self._locked(attempt))
        except OSError:
            ok = False  # the store is unreachable; validity decays
        with self._lock:
            if ok:
                self.renewals += 1
            else:
                self.renew_failures += 1
        if not ok:
            self._handle_lost()
        return ok

    def _handle_lost(self) -> None:
        with self._lock:
            was_held, self._held = self._held, False
        if was_held:
            server_log.warning(
                "lease lost: %s deposed at epoch %d (a successor holds a fresh "
                "lease, or the store is unreachable)", self.holder_id, self.epoch)
            if self._on_lost is not None:
                try:
                    self._on_lost()
                except Exception:  # noqa: BLE001 - a callback never kills renewal
                    pass

    def is_valid(self) -> bool:
        """Local validity: held AND renewed within the lease window."""
        with self._lock:
            return self._held and time.monotonic() - self._renewed_mono < self.lease_s

    # -- the renewal thread --------------------------------------------------

    def start_renewal(self) -> None:
        period = max(0.05, self.lease_s / 3.0)

        def loop() -> None:
            while not self._stop.wait(period):
                self.renew()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"ha-lease-{self.holder_id}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def release(self) -> None:
        """Graceful hand-off: clear the expiry so a standby takes over at
        once. ``_held`` flips FIRST and the written lease carries
        ``released``: both guard against an in-flight renewal re-extending
        what was just handed off."""
        self.stop()
        with self._lock:
            self._held = False

        def attempt() -> None:
            cur = self._read()
            if cur and cur.get("holder") == self.holder_id:
                self._write(dict(cur, expires=0.0, released=True))

        try:
            self._locked(attempt)
        except OSError:
            pass

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            valid = self._held and time.monotonic() - self._renewed_mono < self.lease_s
            return {"holder": self.holder_id, "epoch": self.epoch, "held": self._held,
                    "valid": valid, "lease_s": self.lease_s, "renewals": self.renewals,
                    "renew_failures": self.renew_failures}
