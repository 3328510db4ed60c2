"""A whole run of a cell, cut to a tiny size on the CPU (the look for a
chip skipped), comes out correct; with the timed path broken underneath it
comes out not correct: a served token altered where it is produced, and a
decode step that reads an empty cache in place of the one the prefill
wrote."""
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from chipbench.harness import run_cell
from chipbench.tests.tiny import DENSE, MOE, tiny_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
# Limits for the tiny cells (bfloat16 program, float32 reference): their
# sound runs read token_gap 0-0.002 and logit_err 0.003-0.014.
LIMITS = {"token_gap": 0.05, "logit_err": 0.05}


def _run(name, seed=2**31 + 17):
    cell = tiny_cell(name)
    cell.traffic["check"]["limits"] = dict(LIMITS)
    return run_cell(cell, seed, 0.2, False, device="cpu",
                    t_start=time.perf_counter(), log=lambda *a: None)


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] >= 4
    assert set(out["metrics"]) >= {"tokens_per_s", "latency_p90_s",
                                   "setup_s"}


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_altered_token_is_not_correct(name, monkeypatch):
    from repro_torch.serve.engine import ServingEngine
    real = ServingEngine._next_tokens

    def altered(self, logits):
        tok = real(self, logits)
        return (tok + logits.shape[-1] // 2) % logits.shape[-1]
    monkeypatch.setattr(ServingEngine, "_next_tokens", altered)
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["token_gap"]["value"] > LIMITS["token_gap"]


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_decode_without_the_prefill_cache_is_not_correct(name, monkeypatch):
    from repro_torch.models import transformer as tfm
    real = tfm.forward_decode

    def forgetful(model, cfg, tokens, caches, position, **kw):
        caches = [c._replace(k=torch.zeros_like(c.k), v=torch.zeros_like(c.v))
                  for c in caches]
        return real(model, cfg, tokens, caches, position, **kw)
    monkeypatch.setattr(tfm, "forward_decode", forgetful)
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["logit_err"]["value"] > LIMITS["logit_err"]


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", DENSE, "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


@pytest.mark.parametrize("name", [DENSE, MOE])
def test_control_in_float8_is_not_correct(name):
    """The control, the reference in float8 in the program's place, reads
    above a limit that the program's runs keep to, and the run's own
    verdict on its readings is not correct (``calibrate`` at a tiny
    size)."""
    from chipbench.calibrate import calibrate
    seeds = [2**31 + 40, 2**31 + 41]
    cell = tiny_cell(name)
    cell.traffic["check"]["limits"] = dict(LIMITS)
    got = calibrate(cell, seeds, set(seeds), "cpu", log=lambda s: None)
    assert all(got["lower"][k] <= LIMITS[k] for k in LIMITS)
    assert any(got["upper"][k] > LIMITS[k] for k in LIMITS)
    assert got["correct"] == [True, True]
    assert got["control_correct"] == [False, False]
