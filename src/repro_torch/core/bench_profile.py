"""Measured data-plane throughputs from the bench profiles.

Two profiles are read, never written:

- ``BENCH_engine.json``, the reference package's own file, for the
  ``numpy`` backend (both packages run the same numpy code on the same
  host) and for the sections that do not depend on the backend
  (``tiered_exchange``, ``shuffle``): ``REPRO_BENCH_PROFILE``, then the
  current directory, then the repository root, in the reference's order;
- ``BENCH_engine_torch.json`` for the ``torch`` backend, whose data plane
  runs on the GPU (``python -m repro_torch.bench.engine_bench`` writes
  it on the card), looked up in the same places.

The coordinator's fragment-duration model and the burst planner prefer
those measurements over the hand-set ``CPU_BYTES_PER_S_BY_BACKEND``
constants; every accessor degrades gracefully to the caller's fallback
when the file is absent, stale, or malformed (fresh checkouts, CI
sandboxes).
"""
from __future__ import annotations

import functools
import json
import os
import pathlib
import threading
import warnings
from typing import Optional

MIB = 1024.0 ** 2

_ENV_VAR = "REPRO_BENCH_PROFILE"
# The reference's profile, and the port's own for the torch backend:
# throughputs measured on the GPU never mix with the CPU-measured ones.
_PROFILE_NAME = "BENCH_engine.json"
_TORCH_PROFILE_NAME = "BENCH_engine_torch.json"


def _candidates(name: str) -> list[pathlib.Path]:
    out = []
    env = os.environ.get(_ENV_VAR)
    if env:
        out.append(pathlib.Path(env))
    out.append(pathlib.Path.cwd() / name)
    # src/repro_torch/core/bench_profile.py -> repo root
    out.append(pathlib.Path(__file__).resolve().parents[3] / name)
    return out


@functools.lru_cache(maxsize=8)
def _load_cached(path_key: Optional[str], name: str) -> dict:
    paths = [pathlib.Path(path_key)] if path_key else _candidates(name)
    for p in paths:
        try:
            with open(p) as f:
                data = json.load(f)
            if isinstance(data, dict):
                return data
        except (OSError, ValueError):
            continue
    return {}


def load(path: Optional[str] = None, name: str = _PROFILE_NAME) -> dict:
    """The parsed benchmark profile ``name`` (or the file at ``path``),
    or ``{}`` when unavailable."""
    return _load_cached(str(path) if path is not None else None, name)


def clear_cache() -> None:
    _load_cached.cache_clear()
    with _warn_lock:
        _warned_sections.clear()


def cpu_bytes_per_s(backend: str, fallback: float,
                    path: Optional[str] = None) -> float:
    """Measured pipeline scan/decode throughput (bytes/s) for an engine
    backend, from the ``pipeline`` section of that backend's profile;
    ``fallback`` otherwise."""
    name = _TORCH_PROFILE_NAME if backend == "torch" else _PROFILE_NAME
    pipe = load(path, name).get("pipeline", {})
    mib = pipe.get("batch_mib")
    secs = pipe.get({"numpy": "numpy_s", "torch": "torch_s"}.get(backend))
    if not mib or not secs or secs <= 0:
        return fallback
    return float(mib) * MIB / float(secs)


_warned_sections: set[str] = set()
_warn_lock = threading.Lock()


def section(name: str, path: Optional[str] = None,
            fallback: Optional[dict] = None) -> dict:
    """One benchmark section as a dict; ``fallback`` (default ``{}``) when
    absent or malformed.

    The serving layer reads ``concurrent_serving`` through this to report
    the last recorded throughput/hit-rate alongside live runs; the
    optimizer's exchange-tier placement reads ``tiered_exchange`` for
    measured per-tier throughputs. A *stale* profile — the file exists but
    predates the section, e.g. an old profile on a checkout
    that grew a new bench — warns once per section name and returns the
    fallback, so planner estimates degrade instead of silently running on
    an empty dict nobody noticed. A missing file stays silent: fresh
    checkouts have no profile at all and every accessor already documents
    that fallback.
    """
    fb = {} if fallback is None else fallback
    data = load(path)
    sec = data.get(name)
    if isinstance(sec, dict):
        return sec
    if data:  # profile present but lacks (or mangles) this section: stale
        with _warn_lock:
            if name not in _warned_sections:
                _warned_sections.add(name)
                warnings.warn(
                    f"bench profile has no '{name}' section (stale "
                    f"{_PROFILE_NAME}?);"
                    f" using fallback estimates", RuntimeWarning,
                    stacklevel=2)
    return fb


def shuffle_bytes_per_s(fallback: float,
                        path: Optional[str] = None) -> float:
    """Measured radix partition+serialize throughput (bytes/s)."""
    sh = load(path).get("shuffle", {})
    v = sh.get("radix_mib_s")
    return float(v) * MIB if v else fallback
