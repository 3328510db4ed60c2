"""Performance-variability metrics and regional profiles (paper 4.6, Table 5).

MR: median-to-base-median ratio (normalized to us-east-1).
CoV: coefficient of variation (std/mean, in %) within a region.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np


def cov_sigma(cov_percent: float) -> float:
    """Lognormal sigma matching a target CoV (in %).

    CoV^2 = exp(sigma^2) - 1  =>  sigma = sqrt(ln(1 + CoV^2)). Shared by
    the suite-runtime sampler below and the adaptive layer's straggler
    barrier (``engine.adaptive``), so both speak the same tail model.
    """
    cov = cov_percent / 100.0
    return float(np.sqrt(np.log1p(cov ** 2)))


def median_ratio(runtimes: np.ndarray, base_runtimes: np.ndarray) -> float:
    return float(np.median(runtimes) / np.median(base_runtimes))


def coefficient_of_variation(runtimes: np.ndarray) -> float:
    return float(np.std(runtimes) / np.mean(runtimes) * 100.0)


@dataclasses.dataclass(frozen=True)
class RegionProfile:
    """Calibrated per-region run-time distribution parameters.

    ``cold`` runs (15-min intervals over a workday) see cluster-startup
    contention; ``warm`` runs (back-to-back over 3 h) see pre-provisioned
    resources. EU startup contention drives its ~1.5x median (paper 4.6).
    """

    name: str
    median_scale: float        # vs us-east-1
    cold_cov: float            # target CoV (%) for cold runs
    warm_cov: float


REGIONS = {
    "us-east-1": RegionProfile("us-east-1", 1.00, 22.65, 5.23),
    "eu-west-1": RegionProfile("eu-west-1", 1.50, 4.76, 8.96),
    "ap-northeast-1": RegionProfile("ap-northeast-1", 0.955, 7.65, 6.44),
}


def sample_suite_runtimes(region: str, cold: bool, runs: int,
                          base_median_s: float = 60.0,
                          seed: int = 0) -> np.ndarray:
    """Draw query-suite runtimes whose MR/CoV match the calibrated profile.

    A lognormal with sigma chosen from the target CoV:
    CoV^2 = exp(sigma^2) - 1  =>  sigma = sqrt(ln(1 + CoV^2)).
    """
    prof = REGIONS[region]
    sigma = cov_sigma(prof.cold_cov if cold else prof.warm_cov)
    # Stable digest, NOT hash(): builtin hash of strings is salted by
    # PYTHONHASHSEED, which silently changed the per-(region, cold)
    # stream between processes and made chaos/bench runs irreproducible.
    stream = zlib.crc32(f"{region}|{int(cold)}".encode()) % 2 ** 16
    rng = np.random.default_rng(seed + stream)
    med = base_median_s * prof.median_scale
    mu = np.log(med)
    return rng.lognormal(mu, sigma, size=runs)


def table5(runs: int = 32, seed: int = 0) -> dict[str, dict[str, float]]:
    """Reproduce Table 5: MR and CoV per region, cold and warm."""
    base_cold = sample_suite_runtimes("us-east-1", True, runs, seed=seed)
    base_warm = sample_suite_runtimes("us-east-1", False, runs, seed=seed)
    out: dict[str, dict[str, float]] = {}
    for region in REGIONS:
        cold = sample_suite_runtimes(region, True, runs, seed=seed)
        warm = sample_suite_runtimes(region, False, runs, seed=seed)
        out[region] = {
            "cold_mr": median_ratio(cold, base_cold),
            "cold_cov": coefficient_of_variation(cold),
            "warm_mr": median_ratio(warm, base_warm),
            "warm_cov": coefficient_of_variation(warm),
        }
    return out
