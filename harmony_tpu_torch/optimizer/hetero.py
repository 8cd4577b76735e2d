"""Heterogeneity-aware optimizer + ILP solver.

Parity with the reference's HeterogeneousOptimizer + ILPSolver
(optimizer/impl/hetero/HeterogeneousOptimizer.java, ILPSolver.java, 512 LoC):
minimize mini-batch time by choosing, per executor, (a) its role — table
owner ("server") or trainer ("worker") — and (b) its workload — model blocks
m[i] for owners, data blocks d[i] for trainers — under resource
heterogeneity described by per-host compute rates and link bandwidths
(ref: HostToBandwidthFilePath / HostToCoreFilePath profile files). Like the
reference it (1) does not change the total amount of resources, and
(2) emits a switch-aware migration plan (block transfers only).

Reference-faithful details reproduced:
  * cWProc prediction for rate-unknown executors from core counts:
    assume per-core power T is shared, so T = Σ cWProc[i] / Σ (1/cores[i])
    and an unknown machine with m cores gets cWProc = T/m
    (HeterogeneousOptimizer.java:102-111);
  * EMA smoothing of measured rates (EMA_ALPHA, :192);
  * minimum model blocks per owner (ILPSolver THRESH_MODEL_BLOCK_NUM_PER_EVAL).

TPU-first solver: the reference shells out to Gurobi; a dependency-free
exact solver fits here because the decision space is small (executors =
mesh-slice members, n ≤ pod-slice size). For each candidate owner set
(exhaustive for n ≤ ``exact_enum_limit``, greedy-seeded local search above):
the block splits that minimize the bottleneck time have a closed form in the
continuous relaxation — d[i] ∝ rate[i] for trainers, m[i] ∝ bandwidth[i]
for owners — which is then integer-rounded by largest remainder (the
MIP-gap analogue; the reference runs Gurobi at MIPGap=0.4, far looser than
this rounding error).

A copy of ``harmony_tpu/optimizer/hetero.py``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from harmony_tpu_torch.optimizer.api import DolphinPlan, EvaluatorParams, Optimizer, TransferStep


@dataclasses.dataclass
class ExecutorProfile:
    """Static per-executor resource description (ref: the bandwidth/core
    profile files keyed by hostname)."""

    executor_id: str
    cores: int = 1
    bandwidth: float = 1.0          # relative link bandwidth
    rate: Optional[float] = None    # measured examples/sec (None = unknown)


def load_profiles(
    cores_file: Optional[str] = None, bandwidth_file: Optional[str] = None
) -> Dict[str, ExecutorProfile]:
    """Parse ``host value`` lines (the HostToCoreFilePath/
    HostToBandwidthFilePath format) into profiles."""
    profiles: Dict[str, ExecutorProfile] = {}

    def _read(path):
        out = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                host, val = line.split()
                out[host] = float(val)
        return out

    if cores_file:
        for host, v in _read(cores_file).items():
            profiles.setdefault(host, ExecutorProfile(host)).cores = int(v)
    if bandwidth_file:
        for host, v in _read(bandwidth_file).items():
            profiles.setdefault(host, ExecutorProfile(host)).bandwidth = v
    return profiles


def predict_unknown_rates(profiles: Sequence[ExecutorProfile]) -> None:
    """Fill rate=None entries via the shared per-core-power rule
    (ref: HeterogeneousOptimizer.java:102-111). Mutates in place."""
    known = [p for p in profiles if p.rate is not None and p.rate > 0]
    if not known:
        return
    # T / cores[i] = time-per-block[i]  ->  rate is the inverse notion here:
    # rate[i] = cores[i] / T  with  T = Σ(1/rate) / Σ(1/cores) over known.
    t = sum(1.0 / p.rate for p in known) / sum(1.0 / p.cores for p in known)
    for p in profiles:
        if p.rate is None or p.rate <= 0:
            p.rate = p.cores / t


@dataclasses.dataclass
class Allocation:
    """One solved configuration."""

    owners: Dict[str, int]       # executor -> model blocks
    trainers: Dict[str, int]     # executor -> data blocks
    predicted_time: float = 0.0


def _largest_remainder(total: int, weights: List[float], minimum: int = 0) -> List[int]:
    """Integer split of ``total`` proportional to ``weights`` with a floor."""
    n = len(weights)
    if n == 0:
        return []
    s = sum(weights)
    if s <= 0:
        weights, s = [1.0] * n, float(n)
    floor_total = minimum * n
    spread = total - floor_total
    if spread < 0:  # floor infeasible: plain proportional split
        minimum, spread = 0, total
    raw = [spread * w / s for w in weights]
    out = [minimum + int(r) for r in raw]
    rem = total - sum(out)
    order = sorted(range(n), key=lambda i: raw[i] - int(raw[i]), reverse=True)
    for i in range(rem):
        out[order[i % n]] += 1
    return out


class ILPSolver:
    """Exact role/workload solver (the Gurobi replacement).

    Objective (per mini-batch, mirroring the reference's cost terms):
        time(i in trainers) = d[i] / rate[i]
                              + model_bytes_per_block * Σ_j m[j] / min(bw[i], bw[j])
        minimize  max_i time(i)
    """

    def __init__(self, min_model_blocks_per_owner: int = 5, exact_enum_limit: int = 12):
        self.min_blocks = min_model_blocks_per_owner
        self.exact_enum_limit = exact_enum_limit

    def _eval_owner_set(
        self,
        owner_ids: Tuple[int, ...],
        profiles: Sequence[ExecutorProfile],
        num_data_blocks: int,
        num_model_blocks: int,
        comm_cost_per_block: float,
    ) -> Optional[Allocation]:
        trainer_ids = [i for i in range(len(profiles)) if i not in owner_ids]
        if not trainer_ids or not owner_ids:
            return None
        owners = [profiles[i] for i in owner_ids]
        trainers = [profiles[i] for i in trainer_ids]
        m = _largest_remainder(
            num_model_blocks, [p.bandwidth for p in owners], self.min_blocks
        )
        d = _largest_remainder(num_data_blocks, [p.rate or 1.0 for p in trainers])
        worst = 0.0
        for p, di in zip(trainers, d):
            pull = comm_cost_per_block * sum(
                mj / max(min(p.bandwidth, o.bandwidth), 1e-9)
                for o, mj in zip(owners, m)
            )
            worst = max(worst, di / max(p.rate or 1.0, 1e-9) + pull)
        return Allocation(
            owners={p.executor_id: mi for p, mi in zip(owners, m)},
            trainers={p.executor_id: di for p, di in zip(trainers, d)},
            predicted_time=worst,
        )

    def solve(
        self,
        profiles: Sequence[ExecutorProfile],
        num_data_blocks: int,
        num_model_blocks: int,
        comm_cost_per_block: float = 0.0,
    ) -> Allocation:
        n = len(profiles)
        if n < 2:
            raise ValueError("need at least 2 executors (1 owner + 1 trainer)")
        best: Optional[Allocation] = None

        def consider(owner_ids: Tuple[int, ...]):
            nonlocal best
            alloc = self._eval_owner_set(
                owner_ids, profiles, num_data_blocks, num_model_blocks,
                comm_cost_per_block,
            )
            if alloc and (best is None or alloc.predicted_time < best.predicted_time):
                best = alloc

        if n <= self.exact_enum_limit:
            for k in range(1, n):
                for owner_ids in itertools.combinations(range(n), k):
                    consider(owner_ids)
            assert best is not None
            return best
        # Beyond the enumeration limit: greedy seed (highest-bandwidth
        # executors own, sweep owner count) + bounded swap local search —
        # from the best seed, repeatedly try exchanging one owner with one
        # trainer and moving the boundary by one, keeping improvements,
        # until a pass finds none (or the eval budget runs out). Measured
        # against exact enumeration on random heterogeneous profiles this
        # closes the seed's gap to ~optimal (benchmarks/hetero_quality.py).
        seen = set()
        for owner_ids in self.seed_sweep_sets(profiles):
            seen.add(owner_ids)
            consider(owner_ids)
        assert best is not None
        # evals; each _eval_owner_set is O(|owners|*|trainers|) host math
        # (the nested per-trainer pull sum), so the search is O(n^3) worst
        # case — still microseconds-scale per eval at realistic pool sizes
        budget = 64 * n
        improved = True
        while improved and budget > 0:
            improved = False
            cur = best
            owners = sorted(
                i for i, p in enumerate(profiles)
                if p.executor_id in cur.owners
            )
            trainers = [i for i in range(n) if i not in owners]
            moves = [tuple(sorted(set(owners) - {o} | {t}))
                     for o in owners for t in trainers]
            if len(owners) > 1:
                moves += [tuple(sorted(set(owners) - {o})) for o in owners]
            moves += [tuple(sorted(owners + [t])) for t in trainers]
            for cand in moves:
                if budget <= 0:
                    break
                if cand in seen:  # neighborhoods overlap pass to pass:
                    continue      # spend the budget on UNIQUE sets only
                seen.add(cand)
                budget -= 1
                consider(cand)
            if best.predicted_time < cur.predicted_time - 1e-12:
                improved = True
        return best

    @staticmethod
    def seed_sweep_sets(profiles) -> "list[Tuple[int, ...]]":
        """The greedy-seed owner sets (highest-bandwidth prefix per owner
        count) — the scale path's starting points, exposed so benchmarks
        and tests measure the SAME seed the solver uses."""
        n = len(profiles)
        order = sorted(range(n), key=lambda i: -profiles[i].bandwidth)
        return [tuple(sorted(order[:k])) for k in range(1, n)]


class HeterogeneousOptimizer(Optimizer):
    """Optimizer SPI adapter: metrics -> profiles -> ILP -> migration plan."""

    EMA_ALPHA = 0.5  # (ref: HeterogeneousOptimizer EMA_ALPHA at :192)

    def __init__(
        self,
        profiles: Optional[Dict[str, ExecutorProfile]] = None,
        num_model_blocks: Optional[int] = None,
        min_gain: float = 0.05,
        solver: Optional[ILPSolver] = None,
        comm_cost_per_block: Optional[float] = None,
    ) -> None:
        self.profiles = dict(profiles or {})
        self.num_model_blocks = num_model_blocks
        self.min_gain = min_gain
        self.solver = solver or ILPSolver()
        # None = estimate from measured pull times (see _comm_cost).
        self.comm_cost_per_block = comm_cost_per_block
        self._ema_rates: Dict[str, float] = {}

    # -- metric digestion -------------------------------------------------

    def _update_rates(self, params: EvaluatorParams) -> None:
        # Metrics arrive keyed by worker id; translate to executor ids via
        # params.worker_to_executor (identity when unmapped) so the EMA keys
        # match the profile/block_counts key space.
        per_worker: Dict[str, List[float]] = {}
        for m in params.worker_metrics:
            if m.batch_time_sec > 0:
                eid = params.worker_to_executor.get(m.worker_id, m.worker_id)
                per_worker.setdefault(eid, []).append(
                    m.num_examples / m.batch_time_sec
                )
        for wid, rates in per_worker.items():
            fresh = sum(rates) / len(rates)
            prev = self._ema_rates.get(wid)
            self._ema_rates[wid] = (
                fresh if prev is None
                else prev * self.EMA_ALPHA + fresh * (1 - self.EMA_ALPHA)
            )

    def _build_profiles(self, executor_ids: Sequence[str]) -> List[ExecutorProfile]:
        out = []
        for eid in executor_ids:
            p = self.profiles.get(eid) or ExecutorProfile(eid)
            p = dataclasses.replace(p, rate=self._ema_rates.get(eid, p.rate))
            out.append(p)
        predict_unknown_rates(out)
        return out

    # -- SPI ---------------------------------------------------------------

    def optimize(self, params: EvaluatorParams, num_available_evaluators: int) -> DolphinPlan:
        current = dict(params.block_counts)
        if len(current) < 2:
            return DolphinPlan()
        self._update_rates(params)
        executor_ids = sorted(current)
        profiles = self._build_profiles(executor_ids)
        # The actual block layout is authoritative: planning against any
        # other total would emit a plan whose surplus/deficit pairing can't
        # balance (silently incomplete migrations). num_model_blocks is only
        # a documentation-of-intent fallback for empty layouts.
        total_model_blocks = sum(current.values()) or (self.num_model_blocks or 0)
        num_data_blocks = max(
            len({(m.epoch_idx, m.batch_idx) for m in params.worker_metrics}), 1
        ) * max(len(executor_ids) - 1, 1)
        comm = self._comm_cost(params, total_model_blocks)
        alloc = self.solver.solve(
            profiles, num_data_blocks, total_model_blocks,
            comm_cost_per_block=comm,
        )

        # Current predicted time under the SAME cost model (owners = current
        # block distribution, every executor also training) so the min-gain
        # hysteresis compares commensurate predictions.
        target = {eid: alloc.owners.get(eid, 0) for eid in executor_ids}
        if target == current:
            return DolphinPlan()
        cur_worst = self._predict_current(profiles, current, num_data_blocks, comm)
        if cur_worst > 0 and (cur_worst - alloc.predicted_time) / cur_worst < self.min_gain:
            return DolphinPlan()

        # Switch-aware migration: move surplus blocks from over-loaded to
        # under-loaded executors, largest surplus first (no add/delete — the
        # reference's hetero optimizer keeps the resource set fixed).
        plan = DolphinPlan()
        surplus = sorted(
            ((eid, current[eid] - target[eid]) for eid in executor_ids),
            key=lambda kv: -kv[1],
        )
        deficit = [(eid, need) for eid, need in
                   ((e, target[e] - current[e]) for e in executor_ids) if need > 0]
        di = 0
        for eid, extra in surplus:
            while extra > 0 and di < len(deficit):
                dst, need = deficit[di]
                take = min(extra, need)
                plan.transfer_steps.append(
                    TransferStep(params.table_id or "model", eid, dst, take)
                )
                extra -= take
                need -= take
                if need == 0:
                    di += 1
                else:
                    deficit[di] = (dst, need)
        return plan

    def _comm_cost(self, params: EvaluatorParams, total_model_blocks: int) -> float:
        """Per-(model-block, trainer) pull cost. Explicit config wins;
        otherwise estimated from measured per-batch pull times: with unit
        bandwidths the cost model predicts pull_time ≈ comm * total_blocks."""
        if self.comm_cost_per_block is not None:
            return self.comm_cost_per_block
        pulls = [m.pull_time_sec for m in params.worker_metrics if m.pull_time_sec > 0]
        if not pulls or total_model_blocks <= 0:
            return 0.0
        return (sum(pulls) / len(pulls)) / total_model_blocks

    def _predict_current(
        self,
        profiles: Sequence[ExecutorProfile],
        current: Dict[str, int],
        num_data_blocks: int,
        comm_cost_per_block: float = 0.0,
    ) -> float:
        """Cost of the CURRENT layout: every executor trains (collocated PS)
        and pulls against the current block distribution — the same objective
        the solver minimizes, evaluated at the status quo."""
        d = _largest_remainder(num_data_blocks, [p.rate or 1.0 for p in profiles])
        by_id = {p.executor_id: p for p in profiles}
        owners = [(by_id[e], n) for e, n in current.items() if n > 0 and e in by_id]
        worst = 0.0
        for p, di in zip(profiles, d):
            pull = comm_cost_per_block * sum(
                mj / max(min(p.bandwidth, o.bandwidth), 1e-9)
                for o, mj in owners
            )
            worst = max(worst, di / max(p.rate or 1.0, 1e-9) + pull)
        return worst
