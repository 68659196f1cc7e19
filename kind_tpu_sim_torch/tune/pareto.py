"""Exact Pareto front + knee-point pick for tune results (the port's
copy of ``kind_tpu_sim/tune/pareto.py``).

A point is one evaluated candidate's ``{cost_chip_s, goodput_tok_s,
attainment}`` triple (cost minimized, the other two maximized).
:func:`pareto_front` is the exact non-dominated set — O(n^2) over at
most a few hundred finalists, no approximation — and
:func:`knee_point` picks the front member maximizing min-max
normalized ``goodput - cost`` utility (ties: higher attainment, lower
cost, lower index), a deterministic stand-in for "best trade" that
degrades gracefully to "the only point" on singleton fronts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

# the objective triple every tune metric row carries
COST = "cost_chip_s"
GOODPUT = "goodput_tok_s"
ATTAINMENT = "attainment"


def _coord(point: Dict[str, object], key: str) -> float:
    v = point.get(key)
    return float(v) if v is not None else 0.0


def dominates(a: Dict[str, object], b: Dict[str, object]) -> bool:
    """True when ``a`` is at least as good as ``b`` on every
    objective (cost down, goodput/attainment up) and strictly better
    on at least one."""
    ca, cb = _coord(a, COST), _coord(b, COST)
    ga, gb = _coord(a, GOODPUT), _coord(b, GOODPUT)
    ta, tb = _coord(a, ATTAINMENT), _coord(b, ATTAINMENT)
    if ca > cb or ga < gb or ta < tb:
        return False
    return ca < cb or ga > gb or ta > tb


def pareto_front(points: Sequence[Dict[str, object]]
                 ) -> List[Dict[str, object]]:
    """The exact non-dominated subset, sorted by (cost, -goodput,
    index) for a stable, replayable front. Duplicate coordinates all
    survive (neither dominates the other)."""
    front = [p for p in points
             if not any(dominates(q, p) for q in points)]
    return sorted(front, key=lambda p: (_coord(p, COST),
                                        -_coord(p, GOODPUT),
                                        int(p.get("index", 0))))


def knee_point(front: Sequence[Dict[str, object]]
               ) -> Optional[Dict[str, object]]:
    """The front member with the best normalized goodput-minus-cost
    utility. Cost and goodput are min-max normalized over the front
    (a degenerate axis normalizes to 0 — utility then reduces to the
    surviving axis); attainment breaks ties, then cost, then index."""
    if not front:
        return None
    costs = [_coord(p, COST) for p in front]
    goods = [_coord(p, GOODPUT) for p in front]
    c_lo, c_hi = min(costs), max(costs)
    g_lo, g_hi = min(goods), max(goods)

    def norm(v: float, lo: float, hi: float) -> float:
        return (v - lo) / (hi - lo) if hi > lo else 0.0

    def key(i: int):
        p = front[i]
        utility = (norm(goods[i], g_lo, g_hi)
                   - norm(costs[i], c_lo, c_hi))
        return (-round(utility, 9), -_coord(p, ATTAINMENT),
                costs[i], int(p.get("index", 0)))

    best = min(range(len(front)), key=key)
    return front[best]
