"""Static resource partitioning as a generalized knapsack (paper Fig. 3;
the port's copy of ``repro.core.placement``: pure Python).

Decides, under a monetary/area/power budget, which compute units to
place on which devices ("a training-ready NPU could be integrated to a
home hub" vs. thin clients).  Items are (device, accelerator-option)
pairs; value is the utility of the AI-tasks that placement unlocks;
weight is its cost.  Exact DP solver for integer-cost instances plus a
greedy fallback — both deterministic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence


@dataclass(frozen=True)
class PlacementOption:
    device: str
    accelerator: str          # e.g. "npu-train", "npu-infer", "none"
    cost: int                 # integer budget units (e.g. $)
    utility: float            # aggregate task utility unlocked
    flops: float = 0.0
    train_capable: bool = False


def solve_knapsack(options: Sequence[PlacementOption], budget: int,
                   *, exclusive_per_device: bool = True
                   ) -> tuple[list[PlacementOption], float]:
    """Pick at most one option per device, maximizing utility <= budget.

    Multiple-choice knapsack via DP over (device_group, budget).
    """
    groups: dict[str, list[PlacementOption]] = {}
    for o in options:
        groups.setdefault(o.device, []).append(o)
    if not exclusive_per_device:
        groups = {f"{o.device}#{i}": [o]
                  for i, o in enumerate(options)}

    names = sorted(groups)
    # dp[b] = (utility, chosen tuple)
    dp: list[tuple[float, tuple]] = [(0.0, ())] * (budget + 1)
    for name in names:
        new_dp = list(dp)
        for o in groups[name]:
            if o.cost > budget:
                continue
            for b in range(o.cost, budget + 1):
                cand = dp[b - o.cost]
                val = cand[0] + o.utility
                if val > new_dp[b][0]:
                    new_dp[b] = (val, cand[1] + (o,))
        dp = new_dp
    best = max(dp, key=lambda x: x[0])
    return list(best[1]), best[0]


def greedy_partition(options: Sequence[PlacementOption], budget: int
                     ) -> tuple[list[PlacementOption], float]:
    """Utility-per-cost greedy (fast path for large instances)."""
    chosen: list[PlacementOption] = []
    used_devices: set[str] = set()
    total_u = 0.0
    spend = 0
    for o in sorted(options, key=lambda o: -o.utility / max(o.cost, 1)):
        if o.device in used_devices or spend + o.cost > budget:
            continue
        chosen.append(o)
        used_devices.add(o.device)
        spend += o.cost
        total_u += o.utility
    return chosen, total_u
