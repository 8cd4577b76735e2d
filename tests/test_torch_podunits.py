"""The cross-job unit protocol (``runtime/podunits.py``) against the
reference's.

The port's module is a copy of the reference's; these tests drive both with
the same scripted announcements (TU_WAIT), completions (TU_DONE), job
registrations, follower deaths, failed sends and poisons, on one fake clock,
and hold the port's grants (every TU_GRANT message, in order, with its
``contended`` flag), its leader-local grant flags and its telemetry to the
reference's. The follower side (``FollowerUnits`` and ``PodUnitClient``) is
held to the reference's the same way: the same reports, the same flags.
"""
import pytest

from harmony_tpu.runtime import podunits as ref_units
from harmony_tpu_torch.runtime import podunits as port_units


class _Clock:
    """A fake ``time`` module: ``monotonic`` moves only when told to."""

    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def _drive(module, script, monkeypatch):
    """Run ``script`` on a fresh arbiter of ``module``; returns what it sent
    and what its leader-local waits returned."""
    clock = _Clock()
    monkeypatch.setattr(module, "time", clock)
    sent, failing, seen = [], set(), []

    def send_to(pid, msg):
        if pid in failing:
            raise OSError(f"follower {pid} unreachable")
        sent.append((pid, dict(msg)))

    arb = module.PodUnitArbiter(send_to=send_to)
    for op, *args in script:
        if op == "register":
            arb.register_job(args[0], frozenset(args[1]), *args[2:])
        elif op == "wait":
            arb.on_wait(*args)
        elif op == "done":
            arb.on_done(*args)
        elif op == "dereg":
            arb.deregister_job(args[0])
        elif op == "poison":
            arb.poison()
        elif op == "proc_done":
            arb.proc_done(args[0])
        elif op == "fail":
            failing.add(args[0])
        elif op == "heal":
            failing.discard(args[0])
        elif op == "tick":
            clock.t += args[0]
        elif op == "local":
            # the leader's own leg; scripted only where the unit is grantable
            seen.append(("local", args[0], args[1], arb.local_wait(args[0], args[1], 1.0)))
        seen.append(("sent", len(sent)))
    return sent, seen, arb.grants_total, round(arb.grant_to_done_s, 9)


SCRIPTS = {
    "one-job": [
        ("register", "a", {0, 1}),
        ("wait", "a", 0, 1), ("local", "a", 0), ("done", "a", 0, 1), ("tick", 0.5),
        ("done", "a", 0, 0),
        ("wait", "a", 1, 1), ("tick", 0.25), ("local", "a", 1), ("done", "a", 1, 0),
        ("done", "a", 1, 1), ("dereg", "a"),
    ],
    "two-overlapping-jobs": [
        ("register", "a", {0, 1}), ("register", "b", {0, 1}),
        ("wait", "a", 0, 1), ("wait", "b", 0, 1), ("local", "a", 0),
        ("tick", 0.3), ("done", "a", 0, 0), ("done", "a", 0, 1),
        ("local", "b", 0), ("wait", "a", 1, 1), ("tick", 0.1),
        ("done", "b", 0, 1), ("done", "b", 0, 0),
        ("wait", "b", 1, 1), ("tick", 0.2), ("done", "a", 1, 1), ("done", "a", 1, 0),
        ("dereg", "a"), ("done", "b", 1, 1), ("done", "b", 1, 0), ("dereg", "b"),
    ],
    "disjoint-jobs-grant-at-once": [
        ("register", "a", {0, 1}), ("register", "b", {2, 3}),
        ("wait", "a", 0, 1), ("wait", "b", 0, 2), ("wait", "b", 0, 3),
        ("done", "b", 0, 2), ("done", "b", 0, 3), ("wait", "b", 1, 3),
        ("done", "a", 0, 1), ("done", "a", 0, 0),
    ],
    "deficit-order-and-hold-back": [
        ("register", "a", {0, 1}), ("register", "b", {1, 2}), ("register", "c", {2, 3}),
        ("wait", "a", 0, 1), ("tick", 2.0), ("done", "a", 0, 1), ("done", "a", 0, 0),
        ("wait", "c", 0, 3), ("wait", "a", 1, 1), ("wait", "b", 0, 1), ("wait", "b", 0, 2),
        ("tick", 0.5), ("done", "c", 0, 2), ("done", "c", 0, 3), ("wait", "c", 1, 2),
        ("tick", 0.5), ("done", "a", 1, 1), ("done", "a", 1, 0),
        ("done", "b", 0, 1), ("done", "b", 0, 2), ("done", "c", 1, 2), ("done", "c", 1, 3),
    ],
    "late-arrival-starts-at-the-lowest-deficit": [
        ("register", "a", {0, 1}), ("wait", "a", 0, 1), ("tick", 3.0),
        ("done", "a", 0, 0), ("done", "a", 0, 1),
        ("register", "b", {0, 1}), ("wait", "b", 0, 1), ("wait", "a", 1, 1),
        ("tick", 1.0), ("done", "b", 0, 0), ("done", "b", 0, 1),
        ("done", "a", 1, 0), ("done", "a", 1, 1),
    ],
    "failed-send-is-repaired-on-a-late-or-retried-announce": [
        ("register", "a", {0, 1, 2}), ("fail", 2), ("wait", "a", 0, 1),
        ("heal", 2), ("wait", "a", 0, 2), ("wait", "a", 0, 2, True),
        ("done", "a", 0, 0), ("done", "a", 0, 1), ("done", "a", 0, 2),
        ("wait", "a", 1, 1), ("wait", "a", 1, 2), ("wait", "a", 1, 2, True),
    ],
    "deregistration-releases-outstanding-units": [
        ("register", "a", {0, 1}), ("register", "b", {0, 1}),
        ("wait", "a", 0, 1), ("wait", "b", 0, 1), ("dereg", "a"),
        ("done", "b", 0, 1), ("done", "b", 0, 0), ("wait", "a", 3, 1),
    ],
    "a-dead-follower-no-longer-holds-units": [
        ("register", "a", {0, 1, 2}), ("register", "b", {0, 2}),
        ("wait", "a", 0, 1), ("wait", "b", 0, 2), ("done", "a", 0, 0), ("done", "a", 0, 1),
        ("proc_done", 2), ("done", "b", 0, 0),
    ],
    "poison-grants-everything": [
        ("register", "a", {0, 1}), ("register", "b", {0, 1}),
        ("wait", "a", 0, 1), ("wait", "b", 0, 1), ("wait", "b", 1, 1), ("poison",),
        ("wait", "a", 1, 1), ("local", "b", 2), ("wait", "c", 0, 1),
    ],
    "an-unknown-job-is-granted-at-once": [
        ("wait", "ghost", 4, 1), ("register", "a", {0, 1}), ("wait", "a", 0, 1),
        ("done", "ghost", 4, 1), ("done", "a", 0, 1), ("done", "a", 0, 0),
    ],
    "a-recovery-attempt-inherits-its-deficit": [
        ("register", "a", {0, 1}), ("wait", "a", 0, 1), ("tick", 4.0),
        ("done", "a", 0, 0), ("done", "a", 0, 1), ("dereg", "a"),
        ("register", "b", {0, 1}), ("register", "a@a1", {0, 1}, "a"),
        ("wait", "a@a1", 0, 1), ("wait", "b", 0, 1), ("tick", 0.5),
        ("done", "a@a1", 0, 0), ("done", "a@a1", 0, 1), ("done", "b", 0, 0),
        ("done", "b", 0, 1),
    ],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_the_arbiter_grants_as_the_references(name, monkeypatch):
    want = _drive(ref_units, SCRIPTS[name], monkeypatch)
    got = _drive(port_units, SCRIPTS[name], monkeypatch)
    assert got == want
    grants = [m for _, m in got[0] if m["cmd"] == "TU_GRANT"]
    assert grants, "the script granted nothing"
    if name == "two-overlapping-jobs":
        # overlapping tenants are told they are contended
        assert all(m["contended"] for m in grants)


FOLLOWER_SCRIPTS = {
    "grant-before-wait": [("grant", "a", 0, True), ("scope", "a"), ("grant", "a", 1, False),
                          ("scope", "a")],
    "grants-for-two-jobs": [("grant", "a", 0, False), ("grant", "b", 0, True),
                            ("scope", "b"), ("scope", "a"), ("forget", "a"),
                            ("grant", "a", 1, True), ("scope", "a")],
    "poison-releases-waits": [("poison",), ("scope", "a"), ("scope", "a")],
}


def _drive_follower(module, script):
    reports, flags = [], []
    units = module.FollowerUnits(report=lambda m: reports.append(dict(m)))
    clients = {}
    for op, *args in script:
        if op == "grant":
            units.on_grant(*args)
        elif op == "poison":
            units.on_poison()
        elif op == "forget":
            units.forget(args[0])
            clients.pop(args[0], None)
        elif op == "scope":
            client = clients.setdefault(args[0], module.follower_client(units, args[0]))
            with client.scope(timeout=1.0):
                flags.append(("in", args[0]))
            flags.append(("contended", args[0], client.contended()))
    return reports, flags


@pytest.mark.parametrize("name", sorted(FOLLOWER_SCRIPTS))
def test_the_follower_side_reports_as_the_references(name):
    want = _drive_follower(ref_units, FOLLOWER_SCRIPTS[name])
    got = _drive_follower(port_units, FOLLOWER_SCRIPTS[name])
    assert got == want
    assert [r["cmd"] for r in got[0]].count("TU_DONE") == sum(
        1 for f in got[1] if f[0] == "in")


def test_a_unit_not_granted_in_time_raises_as_the_references():
    for module in (ref_units, port_units):
        units = module.FollowerUnits(report=lambda m: None)
        with pytest.raises(RuntimeError, match="not granted after"):
            units.wait("a", 0, timeout=0.05)
