"""S3 prefix-partition IOPS scaling model (paper 4.4, Figs 11-13).

Measured behaviour encoded here:
  * A fresh prefix is backed by one partition serving 5.5K read / 3.5K write
    IOPS (S3 documentation cites 5,500/3,500 [34]).
  * Under sustained load above capacity, partitions split gradually: the
    paper drives one prefix from 5.5K to 27.5K IOPS (5 partitions) in ~26
    minutes / 63M requests / ~$25, with ~10% of requests throttled
    throughout and an IOPS relative standard deviation up to 29%.
  * Extrapolated (their polynomial fit): ~2 h and $228 to 50K IOPS,
    ~9 h and $1,094 to 100K IOPS.
  * Write IOPS never scale beyond one partition under pure write load.
  * Downscaling: after a full day idle, all partitions remain; two of five
    survive three more days; back to one partition after 4-5 days.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

READ_IOPS_PER_PARTITION = 5500.0
WRITE_IOPS_PER_PARTITION = 3500.0
# Default request-rate quotas before a partition exists to absorb them
# (Fig 9: S3 standard measured just above the documented per-prefix quota).
MEASURED_READ_IOPS_FRESH = 8000.0
MEASURED_WRITE_IOPS_FRESH = 4000.0

# Scaling-law anchors from the paper (IOPS -> minutes, USD).
_ANCHORS = [
    (5500.0, 0.0, 0.0),
    (27500.0, 26.0, 25.0),
    (50000.0, 120.0, 228.0),
    (100000.0, 540.0, 1094.0),
]


# Piecewise log-log interpolation through the paper's anchors; beyond the
# last anchor, extrapolate with the final segment's slope (matching the
# paper's "quickly growing expense" polynomial fit, Fig 12).
_LI = np.log([a[0] for a in _ANCHORS[1:]])
_LT = np.log([a[1] for a in _ANCHORS[1:]])
_LC = np.log([a[2] for a in _ANCHORS[1:]])


def _loglog_interp(x: float, lx: np.ndarray, ly: np.ndarray) -> float:
    l = math.log(x)
    if l >= lx[-1]:
        slope = (ly[-1] - ly[-2]) / (lx[-1] - lx[-2])
        return math.exp(ly[-1] + slope * (l - lx[-1]))
    if l <= lx[0]:
        slope = (ly[1] - ly[0]) / (lx[1] - lx[0])
        return math.exp(ly[0] + slope * (l - lx[0]))
    return math.exp(float(np.interp(l, lx, ly)))


def time_to_reach_iops(target_iops: float) -> float:
    """Minutes of sustained (paper-pattern) load to scale a fresh prefix up
    to ``target_iops`` of read capacity. Fig 12's fitted curve."""
    if target_iops <= READ_IOPS_PER_PARTITION:
        return 0.0
    return _loglog_interp(target_iops, _LI, _LT)


def cost_to_reach_iops(target_iops: float) -> float:
    """USD of request charges spent while scaling up (Fig 12)."""
    if target_iops <= READ_IOPS_PER_PARTITION:
        return 0.0
    return _loglog_interp(target_iops, _LI, _LC)


def partitions_after_idle(initial_partitions: int, idle_hours: float) -> int:
    """Fig 13: staged merge back to a single partition over 4-5 days."""
    if initial_partitions <= 1:
        return 1
    if idle_hours <= 24.0:
        return initial_partitions
    if idle_hours <= 4.25 * 24.0:
        return min(initial_partitions, 2)
    return 1


@dataclasses.dataclass
class PartitionModel:
    """Stateful partition set behind one prefix; drives ObjectStore admission.

    ``offer(t)`` is called per request with the current time (seconds); it
    returns False (throttle) when the arrival rate exceeds the current
    capacity, tracks sustained overload to trigger splits, and merges
    partitions after idle periods.
    """

    partitions: int = 1
    max_partitions: int = 64
    window_s: float = 1.0
    # Sustained overload required per split: calibrated so that the paper's
    # ramp (+~600 IOPS per step, ten 30s repetitions per config) splits
    # 1 -> 5 partitions in ~26 minutes.
    split_after_overload_s: float = 312.0
    rng_seed: int = 0

    def __post_init__(self):
        self._window_start = 0.0
        self._window_count = 0
        self._overload_s = 0.0
        self._last_t = 0.0
        self._rng = np.random.default_rng(self.rng_seed)

    def read_capacity(self) -> float:
        return self.partitions * READ_IOPS_PER_PARTITION

    def write_capacity(self) -> float:
        # Paper 4.4.1: write IOPS do not scale beyond a single partition.
        return WRITE_IOPS_PER_PARTITION

    def offer(self, t: float, write: bool = False) -> bool:
        # Idle-based downscaling.
        idle_h = (t - self._last_t) / 3600.0
        if idle_h > 24.0:
            self.partitions = partitions_after_idle(self.partitions, idle_h)
            self._overload_s = 0.0
        self._last_t = t

        if t - self._window_start >= self.window_s:
            rate = self._window_count / max(self.window_s, 1e-9)
            cap = self.write_capacity() if write else self.read_capacity()
            if rate > cap:
                self._overload_s += self.window_s
                if (not write and self._overload_s >= self.split_after_overload_s
                        and self.partitions < self.max_partitions):
                    self.partitions += 1
                    self._overload_s = 0.0
            else:
                self._overload_s = max(0.0, self._overload_s - self.window_s)
            self._window_start = t
            self._window_count = 0

        self._window_count += 1
        cap = self.write_capacity() if write else self.read_capacity()
        # Admit up to capacity per window; jitter (±) models the paper's
        # up-to-29% relative standard deviation while scaling.
        jitter = 1.0 + 0.1 * self._rng.standard_normal()
        allowed = cap * self.window_s * max(0.1, jitter)
        return self._window_count <= allowed


def simulate_rampup(start_instances: int = 20, step_instances: int = 2,
                    max_instances: int = 100, iops_per_instance: float = 300.0,
                    repetition_s: float = 30.0, reps_per_config: int = 10,
                    seed: int = 0) -> dict[str, np.ndarray]:
    """Reproduce the Fig-11 experiment: a ramped client fleet against one
    prefix. Returns per-repetition offered/successful/failed IOPS and the
    partition count over time."""
    model = PartitionModel(rng_seed=seed)
    rng = np.random.default_rng(seed)
    t = 0.0
    rows = {"t_min": [], "offered": [], "ok": [], "failed": [], "partitions": []}
    instances = start_instances
    while instances <= max_instances:
        for _ in range(reps_per_config):
            offered = instances * iops_per_instance
            # Clients with emptied retry budgets straggle; modeled as a small
            # probability of a repetition dominated by backoff (Fig 11 dips).
            straggler = rng.random() < 0.02
            cap = model.read_capacity()
            ok = min(offered, cap) * (0.35 if straggler else 1.0)
            failed = max(0.0, offered - ok)
            # Sustained overload grows partitions.
            if offered > cap:
                model._overload_s += repetition_s
                if model._overload_s >= model.split_after_overload_s and \
                        model.partitions < model.max_partitions:
                    model.partitions += 1
                    model._overload_s = 0.0
            noise = 1.0 + 0.12 * rng.standard_normal()
            rows["t_min"].append(t / 60.0)
            rows["offered"].append(offered)
            rows["ok"].append(max(0.0, ok * noise))
            rows["failed"].append(failed)
            rows["partitions"].append(model.partitions)
            t += repetition_s
        instances += step_instances
    return {k: np.asarray(v) for k, v in rows.items()}
