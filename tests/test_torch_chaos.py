"""The port's chaos, variability and simulation modules held against the
reference: ``tests/test_chaos.py`` and ``tests/test_variability_sim.py``
run on the reference and, retargeted, on the port
(``test_torch_parity.mirror``), and every fault decision, slowdown draw,
sampled runtime and clock order is the reference's on the same seeds."""
import math

import numpy as np
import pytest

from repro.core import chaos as rchaos
from repro.core import simulation as rsim
from repro.core import variability as rvar
from repro_torch.core import chaos as tchaos
from repro_torch.core import simulation as tsim
from repro_torch.core import variability as tvar
from test_torch_parity import mirror, mirror_env  # noqa: F401

globals().update(mirror("test_chaos"))
globals().update(mirror("test_variability_sim"))

_KNOBS = dict(slow_prob=0.3, drop_prob=0.3, throttle_prob=0.3,
              kill_prob=0.4, oom_prob=0.4, invoke_fail_prob=0.3,
              unavailable_prob=0.3, unavailable_offers=2)


def _decisions(mod, seed):
    """Every kind of fault decision of one seeded policy, in one order,
    with the injected-fault counters after them."""
    ch = mod.ChaosPolicy(seed=seed, **_KNOBS)
    keys = [f"shuffle/q/p/w{w:04d}/r{r:04d}" for w in range(6)
            for r in range(4)] + ["tables/t/part-0", "result/q/c/frag-0"]
    out = {
        "slow": [ch.slow_multiplier(s, i, attempt=a) for s in ("scan", "j")
                 for i in range(12) for a in range(2)],
        "drop": [ch.drop_write(k) for k in keys + keys],
        "throttle": [ch.throttle(k, t=0.5) for k in keys + keys],
        "kill": [ch.kill_after(s, i, a, 8) for s in ("scan", "j")
                 for i in range(8) for a in range(2)],
        "oom": [ch.oom_threshold(s, i, a, 1 << 22) for s in ("scan", "j")
                for i in range(8) for a in range(2)],
        "invoke": [ch.invoke_fail(s, a) for s in range(16)
                   for a in range(3)],
        "unavailable": [ch.unavailable(k) for k in keys for _ in range(3)],
    }
    out["stats"] = ch.stats()
    out["counters"] = (ch.slows, ch.drops, ch.throttles, ch.kills, ch.ooms,
                       ch.invoke_fails, ch.unavailables)
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_every_fault_decision_is_the_reference(seed):
    ref, port = _decisions(rchaos, seed), _decisions(tchaos, seed)
    assert port == ref
    assert any(ref["drop"]) and not all(ref["drop"])
    assert any(k is not None for k in ref["kill"])


def test_another_seed_changes_the_decisions():
    assert _decisions(tchaos, 1) != _decisions(rchaos, 0)


def test_unit_draws_and_probit_are_the_reference():
    ids = [("s", i, a) for i in range(64) for a in range(3)]
    for seed in (0, 3, 2 ** 31 + 5):
        assert [tchaos._unit(seed, *p) for p in ids] == \
            [rchaos._unit(seed, *p) for p in ids]
    for p in (0.0, 1e-12, 0.01, 0.5, 0.975, 1.0):
        assert tchaos._probit(p) == rchaos._probit(p)


def test_variability_model_is_the_reference():
    assert tvar.table5() == rvar.table5()
    assert tvar.table5(runs=8, seed=3) == rvar.table5(runs=8, seed=3)
    for region in rvar.REGIONS:
        for cold in (True, False):
            np.testing.assert_array_equal(
                tvar.sample_suite_runtimes(region, cold=cold, runs=16,
                                           seed=5),
                rvar.sample_suite_runtimes(region, cold=cold, runs=16,
                                           seed=5))
    for cov in (0.0, 5.0, 22.65, 80.0):
        assert tvar.cov_sigma(cov) == rvar.cov_sigma(cov)
    r = np.random.default_rng(0).lognormal(0.0, 0.3, 64)
    assert tvar.coefficient_of_variation(r) == \
        rvar.coefficient_of_variation(r)
    assert tvar.median_ratio(r, r[::-1]) == rvar.median_ratio(r, r[::-1])


def test_simclock_orders_events_as_the_reference():
    def trace(mod):
        clock, fired = mod.SimClock(), []
        rng = np.random.default_rng(4)
        for i, t in enumerate(rng.integers(0, 20, 40) / 4.0):
            clock.at(float(t), lambda i=i: fired.append((clock.now(), i)))

        def chain():
            fired.append((clock.now(), "chain"))
            if clock.now() < 6.0:
                clock.after(math.pi / 2, chain)
        clock.after(0.5, chain)
        clock.run(until=3.0)
        fired.append(("paused", clock.pending(), clock.peek()))
        clock.run()
        return fired, clock.now()
    assert trace(tsim) == trace(rsim)
