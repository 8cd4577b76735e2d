"""The port's TaskUnit schedulers (harmony_tpu_torch/runtime/taskunit.py)
against the reference's (harmony_tpu/runtime/taskunit.py).

The port's module is a copy of the reference's, so the same scripted calls
must give the same answers. Each scripted case plays one sequence of
``on_job_start`` / ``wait_ready`` / ``on_unit_finished`` / ``report_unit_cost``
/ ``on_executor_done`` / ``cancel_wait`` / ``on_job_finish`` calls on one
thread against a fresh ``GlobalTaskUnitScheduler`` of each module, with the
module's clock replaced by a scripted one (the anticipatory hold reads
``time.monotonic``), and ``wait_ready`` polled with ``timeout=0``: a wait
that is not granted returns False and stays registered, as the reference's
abortable scopes leave it. Every answer and the final ``grant_order()`` are
compared exactly. The cases of ``tests/test_jobserver.py::TestTaskUnits``
(deficit fairness, quorum, unregistered pass-through, local slots, client
sequencing) also run as written there, with threads, on each module, and
give the same outcomes. Every wait is bounded.
"""
import threading
import time
import types

import pytest

from harmony_tpu.runtime import taskunit as ref_tu
from harmony_tpu_torch.runtime import taskunit as port_tu

MODULES = {"reference": ref_tu, "port": port_tu}
CPU, NET, VOID = port_tu.CPU, port_tu.NET, port_tu.VOID


class _Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t


def _play(mod, script, monkeypatch):
    """Run ``script`` against ``mod``; returns (answers, grant_order)."""
    clock = _Clock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=clock.monotonic))
    g = mod.GlobalTaskUnitScheduler()
    out = []
    for op, *args in script:
        if op == "meter":
            g.meter_execution = args[0]
        elif op == "start":
            g.on_job_start(*args)
        elif op == "cost":
            g.report_unit_cost(*args)
        elif op == "wait":
            out.append(("wait", args, g.wait_ready(mod.TaskUnitInfo(*args), timeout=0)))
        elif op == "finish":
            g.on_unit_finished(mod.TaskUnitInfo(*args))
        elif op == "cancel":
            out.append(("cancel", args, g.cancel_wait(mod.TaskUnitInfo(*args))))
        elif op == "done":
            g.on_executor_done(*args)
        elif op == "update":
            g.update_job_executors(*args)
        elif op == "end":
            g.on_job_finish(*args)
        elif op == "tick":
            clock.t += args[0]
        elif op == "peer":
            out.append(("peer", args, g.peer_unit_cost(*args)))
        elif op == "jobs":
            out.append(("jobs", g.num_jobs()))
        else:
            raise ValueError(op)
    return out, g.grant_order()


# Scripted cases: (name, script). Units are (job, executor, kind, seq).
SCRIPTS = {
    # tests/test_jobserver.py::TestTaskUnits::test_weighted_fair_grants_favor_cheap_job
    "deficit_fairness": [
        ("start", "cheap", ["c0"]), ("start", "dear", ["d0"]),
        ("cost", "cheap", 0.01), ("cost", "dear", 0.10),
        ("wait", "dear", "d0", CPU, 0), ("tick", 1.0), ("finish", "dear", "d0", CPU, 0),
        ("tick", 1.0),
        ("wait", "cheap", "c0", CPU, 0),
        ("wait", "dear", "d0", CPU, 1),      # dear queues first (earlier arrival)
        ("wait", "cheap", "c0", CPU, 1),     # ...cheap second: both metered out
        ("tick", 1.0), ("finish", "cheap", "c0", CPU, 0),
        ("wait", "cheap", "c0", CPU, 1),     # deficit beats arrival: cheap granted
        ("wait", "dear", "d0", CPU, 1),      # dear still metered out
        ("tick", 1.0), ("finish", "cheap", "c0", CPU, 1),
        ("wait", "dear", "d0", CPU, 1),
        ("peer", "cheap"), ("peer", "dear"),
        ("end", "cheap"), ("end", "dear"), ("jobs",),
    ],
    # ...::test_quorum_grant_and_global_order
    "quorum": [
        ("start", "j", ["e0", "e1"]),
        ("wait", "j", "e0", CPU, 0),         # quorum incomplete
        ("wait", "j", "e1", CPU, 0),         # complete: granted
        ("wait", "j", "e0", CPU, 0),         # the re-entering wait finds its grant
        ("finish", "j", "e0", CPU, 0), ("finish", "j", "e1", CPU, 0),
        ("wait", "j", "e1", NET, 1), ("wait", "j", "e0", NET, 1),
    ],
    # ...::test_unregistered_job_passes_through
    "unregistered_pass_through": [
        ("wait", "ghost", "e", CPU, 0), ("jobs",),
    ],
    # the anticipatory hold: the least-served tenant active within the
    # window keeps the slot from a tenant far ahead of it; the hold lapses
    "anticipatory_hold": [
        ("start", "a", ["a0"]), ("start", "b", ["b0"]),
        ("cost", "a", 0.01), ("cost", "b", 0.01),
        ("wait", "b", "b0", CPU, 0), ("tick", 0.001), ("finish", "b", "b0", CPU, 0),
        ("wait", "b", "b0", CPU, 1), ("tick", 0.001), ("finish", "b", "b0", CPU, 1),
        ("wait", "b", "b0", CPU, 2), ("tick", 0.001), ("finish", "b", "b0", CPU, 2),
        ("wait", "b", "b0", CPU, 3), ("tick", 0.001), ("finish", "b", "b0", CPU, 3),
        ("wait", "a", "a0", CPU, 0), ("tick", 0.001), ("finish", "a", "a0", CPU, 0),
        ("wait", "b", "b0", CPU, 4),         # held for a (active just now)
        ("tick", 0.2),
        ("wait", "b", "b0", CPU, 4),         # the hold lapsed
    ],
    # a departed executor's pending finish is released, and the quorum shrinks
    "executor_done_releases": [
        ("start", "j", ["e0", "e1"]), ("start", "k", ["k0"]),
        ("wait", "j", "e0", CPU, 0), ("wait", "j", "e1", CPU, 0),
        ("finish", "j", "e0", CPU, 0),
        ("wait", "k", "k0", CPU, 0),         # j's unit 0 still open at e1
        ("done", "j", "e1"),
        ("wait", "k", "k0", CPU, 0),
        ("wait", "j", "e0", CPU, 1),         # k's unit holds the meter
        ("finish", "k", "k0", CPU, 0),
        ("wait", "j", "e0", CPU, 1),         # quorum is e0 alone now
    ],
    # late arrival starts at the lowest active deficit (WFQ virtual time)
    "late_arrival_virtual_start": [
        ("start", "a", ["a0"]), ("cost", "a", 0.5),
        ("wait", "a", "a0", CPU, 0), ("finish", "a", "a0", CPU, 0),
        ("wait", "a", "a0", CPU, 1), ("finish", "a", "a0", CPU, 1),
        ("start", "b", ["b0"]), ("cost", "b", 0.5), ("tick", 1.0),
        ("wait", "a", "a0", CPU, 2), ("wait", "b", "b0", CPU, 0),
        ("finish", "a", "a0", CPU, 2), ("wait", "b", "b0", CPU, 0),
    ],
    # a withdrawn wait leaves nothing behind; a raced grant is reported
    "cancel_wait": [
        ("start", "j", ["e0", "e1"]),
        ("wait", "j", "e0", NET, 0), ("cancel", "j", "e0", NET, 0),
        ("wait", "j", "e1", NET, 0),         # e0 withdrew: no grant
        ("wait", "j", "e0", NET, 0),         # e0 back: granted
        ("cancel", "j", "e1", NET, 0),       # already granted: True
    ],
    # execution metering off (the card): contended units of one kind are
    # granted side by side; VOID units never meter
    "unmetered": [
        ("meter", False), ("start", "a", ["a0"]), ("start", "b", ["b0"]),
        ("wait", "a", "a0", CPU, 0), ("wait", "b", "b0", CPU, 0),
        ("wait", "a", "a0", VOID, 1), ("wait", "b", "b0", NET, 1),
    ],
    "void_never_meters": [
        ("start", "a", ["a0"]), ("start", "b", ["b0"]),
        ("wait", "a", "a0", CPU, 0), ("wait", "b", "b0", VOID, 0),
        ("wait", "b", "b0", CPU, 1), ("wait", "b", "b0", NET, 2),
    ],
    # reconfiguration changes the quorum
    "update_quorum": [
        ("start", "j", ["e0", "e1", "e2"]),
        ("wait", "j", "e0", CPU, 0), ("wait", "j", "e1", CPU, 0),
        ("update", "j", ["e0", "e1"]),
        ("wait", "j", "e0", CPU, 0),
    ],
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_scripted_grants_match_the_reference(case, monkeypatch):
    ref = _play(ref_tu, SCRIPTS[case], monkeypatch)
    mine = _play(port_tu, SCRIPTS[case], monkeypatch)
    assert mine == ref
    assert ref[1] or case == "unregistered_pass_through"


def test_scripted_hold_and_release_read_off_the_port(monkeypatch):
    """What the hold and departure cases show, read off the port's answers:
    the slot is held for the least-served tenant until the window lapses,
    and a departed executor's open unit no longer meters its peers."""
    out, _ = _play(port_tu, SCRIPTS["anticipatory_hold"], monkeypatch)
    assert [o[-1] for o in out][-2:] == [False, True]
    out, order = _play(port_tu, SCRIPTS["executor_done_releases"], monkeypatch)
    assert [o[-1] for o in out] == [False, True, False, True, False, True]
    assert order[-1] == ("j", 1, CPU)


def test_scripted_fairness_grants_the_cheap_job_first(monkeypatch):
    """What the deficit case shows, read off the port's answers."""
    out, order = _play(port_tu, SCRIPTS["deficit_fairness"], monkeypatch)
    assert order == [("dear", 0, CPU), ("cheap", 0, CPU), ("cheap", 1, CPU),
                     ("dear", 1, CPU)]
    assert ("peer", ["cheap"], 0.1) in out and ("jobs", 0) in out


def _client_sequence(mod):
    g = mod.GlobalTaskUnitScheduler()
    local = mod.LocalTaskUnitScheduler()
    g.on_job_start("j", ["e0"])
    c = mod.TaskUnitClient("j", "e0", g, local)
    for phase in (CPU, NET, "COMP", "PULL", "PUSH", "SYNC"):
        with c.scope(phase):
            pass
    with pytest.raises(mod.TaskUnitAborted):
        # a peer's unit holds the quorum open: the abortable wait gives up
        g.on_job_start("k", ["k0", "k1"])
        mod.TaskUnitClient("k", "k0", g, local).scope(
            NET, abort=lambda: True, poll=0.01).__enter__()
    return g.grant_order(), c.contended()


def test_client_scope_sequences_match_the_reference():
    """...::test_client_scope_sequences, with every phase name and an
    aborted admission wait."""
    ref, mine = _client_sequence(ref_tu), _client_sequence(port_tu)
    assert mine == ref
    assert [k for (_, _, k) in mine[0]] == [CPU, NET, CPU, NET, NET, VOID]


# -- the reference's threaded cases, on each module ---------------------------


@pytest.mark.parametrize("which", sorted(MODULES))
def test_weighted_fair_grants_favor_cheap_job(which):
    mod = MODULES[which]
    g = mod.GlobalTaskUnitScheduler()
    g.on_job_start("cheap", ["c0"])
    g.on_job_start("dear", ["d0"])
    g.report_unit_cost("cheap", 0.01)
    g.report_unit_cost("dear", 0.10)
    u_d0 = mod.TaskUnitInfo("dear", "d0", CPU, 0)
    assert g.wait_ready(u_d0, timeout=5)
    g.on_unit_finished(u_d0)
    u_c0 = mod.TaskUnitInfo("cheap", "c0", CPU, 0)
    assert g.wait_ready(u_c0, timeout=5)
    granted = []

    def waiter(job, eid, seq):
        u = mod.TaskUnitInfo(job, eid, CPU, seq)
        if g.wait_ready(u, timeout=10):
            granted.append((job, u))

    td = threading.Thread(target=waiter, args=("dear", "d0", 1))
    td.start()
    time.sleep(0.1)
    tc = threading.Thread(target=waiter, args=("cheap", "c0", 1))
    tc.start()
    time.sleep(0.1)
    assert granted == []
    g.on_unit_finished(u_c0)
    tc.join(timeout=10)
    assert [j for j, _ in granted] == ["cheap"]
    assert td.is_alive()
    g.on_unit_finished(granted[0][1])
    td.join(timeout=10)
    assert not td.is_alive() and [j for j, _ in granted] == ["cheap", "dear"]
    g.on_job_finish("cheap")
    g.on_job_finish("dear")


@pytest.mark.parametrize("which", sorted(MODULES))
def test_quorum_grant_and_global_order(which):
    mod = MODULES[which]
    g = mod.GlobalTaskUnitScheduler()
    g.on_job_start("j", ["e0", "e1"])
    granted = []

    def worker(eid):
        if g.wait_ready(mod.TaskUnitInfo("j", eid, CPU, 0), timeout=5):
            granted.append(eid)

    t0 = threading.Thread(target=worker, args=("e0",))
    t0.start()
    time.sleep(0.1)
    assert granted == []
    t1 = threading.Thread(target=worker, args=("e1",))
    t1.start()
    t0.join(timeout=5)
    t1.join(timeout=5)
    assert sorted(granted) == ["e0", "e1"]
    assert g.grant_order() == [("j", 0, CPU)]


@pytest.mark.parametrize("which", sorted(MODULES))
@pytest.mark.parametrize("kind,slots", [(CPU, 1), (NET, 2)])
def test_local_slots_bound_concurrency(which, kind, slots):
    """...::test_local_slots_bound_concurrency, for both slot pools: at most
    ``slots`` holders at once of four."""
    local = MODULES[which].LocalTaskUnitScheduler(cpu_slots=1, net_slots=2)
    running = {"now": 0, "max": 0}
    lock = threading.Lock()

    def use():
        local.acquire(kind)
        with lock:
            running["now"] += 1
            running["max"] = max(running["max"], running["now"])
        time.sleep(0.05)
        with lock:
            running["now"] -= 1
        local.release(kind)

    ts = [threading.Thread(target=use) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    assert running["max"] == slots


def test_the_port_imports_nothing_of_the_reference():
    src = open(port_tu.__file__).read()
    assert "harmony_tpu." not in src.replace("harmony_tpu_torch", "") and "jax" not in src
