"""Multi-stage overlap solver (ref: magi_attention/meta/solver/overlap_solver.py:41-222).

The port's copy of ``magiattention_tpu/meta/solver/overlap_solver.py`` (numpy only, imports
rewired).

Decides the overlap degree and groups a rank's remote workload items into
stages so that stage i+1's communication hides under stage i's compute.

Cost model (ref OverlapStageCost :160): per stage, comm_cost is proportional
to the rows moved over ICI and calc_cost to the attention area computed
against that stage's buffer. The pipeline makespan for stages 0..n-1 is
  comm_0 + max over orderings of hidden comm/calc — approximated as the
  classic two-stage pipeline bound used by the reference:
  makespan = comm_0 + sum_i max(calc_i, comm_{i+1}) + calc_{n-1}.

Algorithms:
  UniformOverlapAlg — split items into `degree` groups of near-equal rows.
  GreedyOverlapAlg  — sweep degrees 1..max_degree, greedily pack items into
  the stage with the lowest current cost, keep the degree minimizing the
  modeled makespan (the "adaptive" part of adaptive multi-stage overlap).

Two-level (dcn, ici) meshes price the slow inter-slice fabric separately:
items carry ``dcn_rows`` (post-dedup phase-A volume), stage costs gain
``dcn_cost``, and ``two_level_makespan`` models the DCN link as a third
pipeline resource so stage i's DCN transfer hides under stages i-1..i's
ICI comm + calc.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...common.enum import OverlapAlgType
from ...config import OverlapConfig

# built-in DCN cost constant: one DCN row costs ~8x an ICI row
DCN_PER_ROW = 8.0


def _calibrated_dcn_per_row() -> float:
    """DCN_PER_ROW, or the telemetry store's fitted ``dcn_per_row`` when
    calibration is on and a two_level_makespan fit has converged."""
    from ...env import backend as env_backend

    if not env_backend.calibration_enabled():
        return DCN_PER_ROW
    from ...telemetry import store as _store

    return float(_store.calibrated("dcn_per_row", DCN_PER_ROW))


@dataclass
class OverlapStageCost:
    comm_cost: float = 0.0
    calc_cost: float = 0.0
    # two-level plans only: the stage's DCN phase-A volume, priced
    # separately because the inter-slice fabric is ~10x slower than ICI
    dcn_cost: float = 0.0


@dataclass
class OverlapItem:
    """One remote workload unit (a merged remote kv interval)."""

    rows: int  # rows fetched (comm volume proxy)
    area: int  # attention area computed against these rows (calc proxy)
    dcn_rows: int = 0  # subset of rows crossing the DCN fabric (post-dedup)


def pipeline_makespan(costs: list[OverlapStageCost], host_calc: float) -> float:
    """Modeled makespan: stage-0 comm is exposed behind host compute; each
    later stage's comm hides under the previous stage's calc."""
    if not costs:
        return host_calc
    span = max(costs[0].comm_cost, host_calc)
    for i in range(len(costs)):
        nxt_comm = costs[i + 1].comm_cost if i + 1 < len(costs) else 0.0
        span += max(costs[i].calc_cost, nxt_comm)
    return span


def two_level_makespan(costs: list[OverlapStageCost], host_calc: float) -> float:
    """Two-fabric pipeline bound for (dcn, ici) meshes.

    A stage's DCN phase-A must land before its ICI phase-B can forward, and
    the DCN link, the ICI link, and the compute units each serve stages in
    order — a three-resource flow shop. Stage i's DCN transfer therefore
    hides under stages i-1..i's ICI comm + calc; only the DCN time that
    outruns both is exposed. With all ``dcn_cost`` zero this is the same
    schedule ``pipeline_makespan`` bounds (the DCN resource sits idle).
    """
    if not costs:
        return host_calc
    dcn_done, ici_done, calc_done = 0.0, 0.0, host_calc
    for c in costs:
        dcn_done += c.dcn_cost
        ici_done = max(dcn_done, ici_done) + c.comm_cost
        calc_done = max(ici_done, calc_done) + c.calc_cost
    return calc_done


class OverlapSolver:
    """Groups items into stages (ref OverlapSolver.solve :222)."""

    def __init__(self, config: OverlapConfig | None = None) -> None:
        self.config = config or OverlapConfig()

    def solve(
        self,
        items: list[OverlapItem],
        host_calc: float = 0.0,
        comm_per_row: float = 1.0,
        calc_per_area: float = 1.0,
        dcn_per_row: float | None = None,
    ) -> tuple[list[int], list[OverlapStageCost]]:
        """Returns (stage id per item, per-stage costs).

        ``dcn_per_row=None`` resolves through the telemetry store's
        calibrated constant (fit from two_level_makespan drift
        observations) and falls back to the built-in 8.0 when no store is
        active or no fit has converged.
        """
        if dcn_per_row is None:
            dcn_per_row = _calibrated_dcn_per_row()
        if not items:
            return [], []
        cfg = self.config
        if not cfg.enable:
            return [0] * len(items), self._costs(items, [0] * len(items), 1,
                                                 comm_per_row, calc_per_area,
                                                 dcn_per_row)
        if cfg.degree is not None:
            degree = max(1, min(cfg.degree, len(items)))
            assign = (
                self._uniform(items, degree)
                if cfg.alg == OverlapAlgType.UNIFORM
                else self._greedy(items, degree)
            )
            return assign, self._costs(items, assign, degree,
                                       comm_per_row, calc_per_area,
                                       dcn_per_row)

        # dynamic: sweep degrees, keep the best modeled makespan. Two-level
        # items (any dcn_rows) are priced with the two-fabric flow-shop
        # bound so a degree that pipelines DCN under ICI stages can win.
        makespan = (
            two_level_makespan
            if any(it.dcn_rows for it in items)
            else pipeline_makespan
        )
        best = None
        max_deg = min(len(items), cfg.max_num_chunks, 8)
        for degree in range(1, max_deg + 1):
            assign = self._greedy(items, degree)
            costs = self._costs(items, assign, degree,
                                comm_per_row, calc_per_area, dcn_per_row)
            span = makespan(costs, host_calc)
            if best is None or span < best[0]:
                best = (span, assign, costs)
        return best[1], best[2]

    @staticmethod
    def _uniform(items: list[OverlapItem], degree: int) -> list[int]:
        total = sum(it.rows for it in items)
        target = max(1, -(-total // degree))
        assign, st, acc = [], 0, 0
        for it in items:
            assign.append(min(st, degree - 1))
            acc += it.rows
            if acc >= target * (st + 1) and st < degree - 1:
                st += 1
        return assign

    @staticmethod
    def _greedy(items: list[OverlapItem], degree: int) -> list[int]:
        order = sorted(range(len(items)), key=lambda i: -items[i].rows)
        loads = [0] * degree
        assign = [0] * len(items)
        for i in order:
            st = min(range(degree), key=lambda s: loads[s])
            assign[i] = st
            loads[st] += items[i].rows
        return assign

    @staticmethod
    def _costs(items, assign, degree, comm_per_row, calc_per_area,
               dcn_per_row=DCN_PER_ROW):
        costs = [OverlapStageCost() for _ in range(degree)]
        for it, st in zip(items, assign):
            costs[st].comm_cost += it.rows * comm_per_row
            costs[st].calc_cost += it.area * calc_per_area
            costs[st].dcn_cost += it.dcn_rows * dcn_per_row
        return costs
