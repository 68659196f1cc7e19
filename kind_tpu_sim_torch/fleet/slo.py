"""Streaming SLO accounting: percentiles without unbounded state.

The port's copy of ``kind_tpu_sim/fleet/slo.py``. Percentiles come from
:class:`FixedBucketHistogram` (geometric buckets over a fixed range,
one bisect an observation, the bucket's upper bound as the estimate);
:class:`SloTracker` adds attainment and goodput: a request attains when
every configured target (TTFT, TPOT, e2e) holds and it was neither shed
nor deadline-expired. Goodput counts attained requests' tokens,
throughput every completed one's.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Sequence


class FixedBucketHistogram:
    """Geometric fixed-bucket histogram over (0, hi]: bucket upper
    bounds grow by ``growth`` from ``lo`` to ``hi``, values above ``hi``
    land in an overflow bucket whose reported bound is the largest value
    seen."""

    def __init__(self, lo: float = 1e-4, hi: float = 1e3,
                 growth: float = 1.12):
        if not (0 < lo < hi and growth > 1.0):
            raise ValueError(
                f"need 0 < lo < hi and growth > 1; got lo={lo} "
                f"hi={hi} growth={growth}")
        bounds: List[float] = []
        b = lo
        while b < hi:
            bounds.append(b)
            b *= growth
        bounds.append(hi)
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # + overflow
        self.total = 0
        self._max = 0.0
        self._sum = 0.0

    def observe(self, value: float, count: int = 1) -> None:
        """Record ``count`` occurrences of ``value``."""
        if value < 0 or math.isnan(value):
            raise ValueError(f"bad latency sample {value!r}")
        idx = bisect.bisect_left(self.bounds, value)
        self.counts[idx] += count
        self.total += count
        self._sum += value * count
        if value > self._max:
            self._max = value

    def percentile(self, p: float) -> Optional[float]:
        """Upper-bound estimate of the p-quantile; None when empty."""
        if not self.total:
            return None
        rank = p * self.total
        cum = 0
        for idx, count in enumerate(self.counts):
            cum += count
            if cum >= rank and count:
                if idx >= len(self.bounds):
                    return self._max
                return min(self.bounds[idx], self._max)
        return self._max

    @property
    def mean(self) -> Optional[float]:
        return self._sum / self.total if self.total else None

    def report(self) -> Dict[str, float]:
        if not self.total:
            return {"count": 0}
        return {
            "count": self.total,
            "p50_s": round(self.percentile(0.50), 6),
            "p90_s": round(self.percentile(0.90), 6),
            "p99_s": round(self.percentile(0.99), 6),
            "mean_s": round(self.mean, 6),
            "max_s": round(self._max, 6),
        }


@dataclasses.dataclass(frozen=True)
class SloPolicy:
    """Per-request latency targets (None: unconstrained). ``itl_s`` is
    the inter-token target of the simulator's disaggregated pools; it
    does not enter :meth:`attained`."""

    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    e2e_s: Optional[float] = None
    itl_s: Optional[float] = None

    def attained(self, ttft: float, tpot: Optional[float],
                 e2e: float) -> bool:
        if self.ttft_s is not None and ttft > self.ttft_s:
            return False
        if (self.tpot_s is not None and tpot is not None
                and tpot > self.tpot_s):
            return False
        if self.e2e_s is not None and e2e > self.e2e_s:
            return False
        return True


class SloTracker:
    """Per-completion SLO accounting for one fleet run: three
    histograms and a few counters. With ``track_itl`` (the
    disaggregated fleet's tracker) a fourth histogram weighs every
    inter-token gap alike (a request of n tokens adds n - 1 of them),
    and the report gains its ``itl`` section."""

    def __init__(self, policy: SloPolicy,
                 hist_lo: float = 1e-4, hist_hi: float = 1e3,
                 track_itl: bool = False):
        self.policy = policy
        self.ttft = FixedBucketHistogram(hist_lo, hist_hi)
        self.tpot = FixedBucketHistogram(hist_lo, hist_hi)
        self.e2e = FixedBucketHistogram(hist_lo, hist_hi)
        self.track_itl = track_itl
        self.itl = FixedBucketHistogram(hist_lo, hist_hi)
        self.completed = 0
        self.attained = 0
        self.shed = 0
        self.expired = 0
        self.tokens_total = 0
        self.tokens_good = 0
        self._span_end = 0.0

    def observe(self, *, arrival_s: float, first_s: Optional[float],
                finish_s: float, tokens: int, shed: bool = False,
                deadline_exceeded: bool = False) -> bool:
        """Record one terminal outcome; returns whether it attained.
        Shed requests count in the denominator: shedding is a miss the
        policy chose."""
        self._span_end = max(self._span_end, finish_s)
        if shed:
            self.shed += 1
            self.completed += 1
            return False
        ttft = (first_s if first_s is not None else finish_s) - arrival_s
        e2e = finish_s - arrival_s
        tpot = ((finish_s - first_s) / (tokens - 1)
                if first_s is not None and tokens > 1 else None)
        self.ttft.observe(ttft)
        self.e2e.observe(e2e)
        if tpot is not None:
            self.tpot.observe(tpot)
            if self.track_itl:
                self.itl.observe(tpot, count=tokens - 1)
        self.completed += 1
        self.tokens_total += tokens
        if deadline_exceeded:
            self.expired += 1
            return False
        ok = self.policy.attained(ttft, tpot, e2e)
        if ok:
            self.attained += 1
            self.tokens_good += tokens
        return ok

    @property
    def attainment(self) -> Optional[float]:
        if not self.completed:
            return None
        return self.attained / self.completed

    def report(self, span_s: Optional[float] = None) -> Dict[str, object]:
        """``span_s``: the virtual span goodput and throughput are taken
        over (default: the last finish seen)."""
        span = span_s if span_s else self._span_end
        out: Dict[str, object] = {
            "policy": {k: v for k, v in
                       dataclasses.asdict(self.policy).items()
                       if v is not None},
            "completed": self.completed,
            "attained": self.attained,
            "attainment": (round(self.attainment, 6)
                           if self.completed else None),
            "shed": self.shed,
            "deadline_exceeded": self.expired,
            "ttft": self.ttft.report(),
            "tpot": self.tpot.report(),
            "e2e": self.e2e.report(),
        }
        if self.track_itl:
            out["itl"] = self.itl.report()
        if span and span > 0:
            out["throughput_tok_s"] = round(self.tokens_total / span, 3)
            out["goodput_tok_s"] = round(self.tokens_good / span, 3)
        return out


def brute_force_percentile(samples: Sequence[float],
                           p: float) -> Optional[float]:
    """Nearest-rank percentile over a sorted copy: the exact value the
    histogram estimates, for windows small enough to sort (None for no
    samples)."""
    if not samples:
        return None
    ordered = sorted(samples)
    rank = max(0, math.ceil(p * len(ordered)) - 1)
    return ordered[rank]
