"""The TMA-fed RG-LRU scan's launch plan and stage order, on the CPU.

``csrc/rglru_scan_tma.cu`` runs only on an H100, so this file checks
what surrounds it in Python and replays its pipeline on the host:

- ``_plan`` at RecurrentGemma-2B's prefill shape, at one batch row, and
  at a ragged S and a ragged W: every (batch, channel) lane belongs to
  exactly one block, the whole grid is resident at once on 132 SMs, a
  block's shared memory stays within the 232,448 bytes one block may
  take, and the stages cover every step; ``_route`` sends a W whose rows
  TMA cannot address (W * 4 not a multiple of 16 bytes) to ``"seq"``.
- A host emulation of the kernel: its ring slots, ``mbarrier`` phase
  parities, barrier counts, box coordinates and staging tiles are read
  out of the ``.cu`` source and replayed over the very boxes the plan
  gives, the producer, the consumer warps and the TMA copies interleaved
  in a seeded random order (loads land out of order, stores read their
  tile late). It must never overwrite a stage a warp has not copied or a
  staging tile a store has not read, must fold each (step, lane) once
  and in order, and must equal the plain version (``rglru_scan_plain``)
  and the Pallas ``rglru_scan_blocked`` in interpret mode within 1e-5
  (the reference's own kernel tolerance). A ring whose producer skips
  the wait for an empty stage must break it.

Inputs are made with numpy from a seed.
"""
import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import rglru_scan_blocked
from repro_torch.kernels import rglru_scan as trg

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = (pathlib.Path(trg.__file__).resolve().parents[1] / "csrc"
          / "rglru_scan_tma.cu").read_text()
H100_SMS = 132
SMEM_PER_SM = 233_472          # 228 KB of shared memory an SM
SMEM_PER_BLOCK = 232_448       # the most one block may take
THREADS_PER_SM = 2_048
TOL = 1e-5

SHAPES = {"serve": (4, 4096, 2560), "b1": (1, 4096, 2560),
          "ragged_s": (4, 1000, 2560), "ragged_w": (1, 1000, 2564),
          "ragged_w_b4": (4, 4096, 2564)}


# -- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_covers_every_lane_once(name):
    b, s, w = SHAPES[name]
    plan = trg._plan(b, s, w, sms=H100_SMS)
    seen = np.zeros((b, w), np.int64)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            lanes = bx * plan.lanes + np.arange(plan.lanes)
            seen[by, lanes[lanes < w]] += 1
    assert plan.grid[1] == b
    assert (seen == 1).all()
    assert _Kernel.steps == trg.STEPS


@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_is_one_wave_within_shared_memory(name):
    b, s, w = SHAPES[name]
    plan = trg._plan(b, s, w, sms=H100_SMS)
    assert plan.smem <= SMEM_PER_BLOCK
    assert plan.stages >= 2
    # Dynamic shared memory: the ring, two staging tiles of h, and a full
    # and an empty mbarrier per stage, as the kernel lays it out.
    assert plan.smem == plan.stages * (2 * trg.STEPS * plan.lanes * 4 + 16) \
        + 2 * trg.STEPS * plan.lanes * 4
    assert plan.smem == _c(_Kernel.smem, stages=plan.stages,
                           kSteps=_Kernel.steps, L=plan.lanes)
    resident = min((SMEM_PER_SM // (plan.smem + 1_024)),
                   THREADS_PER_SM // plan.threads, 32)
    assert plan.grid[0] * plan.grid[1] <= H100_SMS * resident
    assert plan.threads == 32 + max(plan.lanes, 32)


def test_plan_at_the_serving_shape():
    # RecurrentGemma-2B's prefill: 128-channel tiles (512-byte rows), one
    # block on each of 80 SMs, two stages of 64 KB.
    plan = trg._plan(4, 4096, 2560, sms=H100_SMS)
    assert (plan.lanes, plan.stages, plan.grid) == (128, 2, (20, 4))


def test_plan_overrides_and_small_grids():
    # The plans scripts/rglru_variants.py launches in place of ``_plan``'s
    # fit a block's shared memory at the shapes it times.
    spec = importlib.util.spec_from_file_location(
        "rglru_variants", ROOT / "scripts" / "rglru_variants.py")
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    for b, s, w in variants.SHAPES.values():
        for name, (lanes, stages) in variants.PLANS.items():
            lanes = lanes or trg._plan(b, s, w, sms=H100_SMS).lanes
            stages = stages or trg._depth(-(-w // lanes) * b, s, lanes,
                                          H100_SMS)
            steps = 32 if name == "steps32" else trg.STEPS
            smem = _c(_Kernel.smem, stages=stages, kSteps=steps, L=lanes)
            assert 2 <= stages and smem <= SMEM_PER_BLOCK, (name, b)
    # Too few lanes for a quarter of the SMs: the narrowest tile, and no
    # more stages than S has.
    plan = trg._plan(1, 100, 64, sms=H100_SMS)
    assert (plan.lanes, plan.stages, plan.grid) == (32, 2, (2, 1))


@pytest.mark.parametrize("w,route", [(2560, "tma"), (2564, "tma"),
                                     (4, "tma"), (2562, "seq"),
                                     (2563, "seq"), (2561, "seq"),
                                     (6, "seq")])
def test_route(w, route):
    assert trg._route(4096, w) == route
    assert trg._route(1000, w) == route


def test_route_keeps_the_batch_stride_within_tma():
    assert trg._route(2 ** 26, 4096) == "seq"     # S * W * 4 = 2^40 bytes
    assert trg._route(2 ** 26 - 1, 4096) == "tma"


# -- the stage order ----------------------------------------------------------

def _source_expr(pattern: str) -> str:
    found = re.findall(pattern, SOURCE)
    assert found, f"rglru_scan_tma.cu no longer matches {pattern!r}"
    assert len(set(found)) == 1, found
    return found[0]


def _c(expr: str, **names) -> int:
    """A C integer expression of the kernel, on non-negative ints."""
    return eval(expr.replace("/", "//"), {}, names)  # noqa: S307


class _Kernel:
    """What the host emulation takes from the source."""
    slot = _source_expr(r"const int slot = (.+?);")
    empty_parity = _source_expr(
        r"if \(i >= stages\) mbar_wait\(empty \+ 8 \* slot, (.+?)\);")
    full_parity = _source_expr(r"mbar_wait\(full \+ 8 \* slot, (.+?)\);")
    full_count = _source_expr(r"mbar_init\(full \+ 8 \* slot, (.+?)\);")
    empty_count = _source_expr(
        r"mbar_init\(empty \+ 8 \* slot, (.+?)\);")
    load_at = _source_expr(
        r"tma_load\(dst, &map_a, full \+ 8 \* slot, (.+?)\);")
    store_at = _source_expr(r"tma_store\(&map_h, smem_u32\(tile\), (.+?)\);")
    tile = _source_expr(r"float\* tile = stg \+ (.+?) \* kTile;")
    stores_pending = int(_source_expr(
        r"cp\.async\.bulk\.wait_group\.read (\d+);"))
    steps = int(_source_expr(r"constexpr int kSteps = (\d+);"))
    smem = _source_expr(r"constexpr int smem_bytes\(int stages\) \{\n"
                        r"  return (.+?);")


class _MBarrier:
    """An mbarrier's phases: a phase completes when its arrivals and its
    expected transaction bytes are all in; ``try_wait(p)`` succeeds once
    the phase of parity p has completed."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, tx=0):
        self.tx += tx
        self.pending -= 1
        assert self.pending >= 0, "more arrivals than the barrier's count"
        self._complete()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        assert self.tx >= 0
        self._complete()

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def try_wait(self, parity):
        return (self.phase & 1) != parity


def _emulate_block(la, bb, h0, h_all, h_last, folded, plan, bi, bx, rng,
                   skip_empty_wait=False):
    """One block of the kernel: its producer thread, its consumer warps
    and its TMA copies as coroutines run in a random order."""
    k = _Kernel
    s, w = la.shape[1], la.shape[2]
    lanes, stages, steps = plan.lanes, plan.stages, k.steps
    c0 = bx * lanes
    chunks = -(-s // steps)
    warps = -(-lanes // 32)
    full = [_MBarrier(_c(k.full_count)) for _ in range(stages)]
    empty = [_MBarrier(_c(k.empty_count, L=lanes)) for _ in range(stages)]
    ring = [None] * stages            # (chunk, log_a box, b box) per slot
    copied = [-1] * warps             # the last chunk each warp copied
    staging = [None, None]
    unread = []                       # stores issued, tile not yet read
    sync = {"arrived": 0, "generation": 0}
    inflight = []                     # loads issued, not landed
    box_bytes = 2 * steps * lanes * 4

    def box(x, chunk):
        at = _c(k.load_at, c0=c0, i=chunk, kSteps=steps, bi=bi)
        assert at == (c0, chunk * steps, bi)
        out = np.zeros((steps, lanes), np.float32)   # TMA's zero fill
        t = x[bi, chunk * steps:(chunk + 1) * steps, c0:c0 + lanes]
        out[:t.shape[0], :t.shape[1]] = t
        return out

    def land(load):
        slot, chunk = load
        if chunk >= stages:
            assert min(copied) >= chunk - stages, \
                "a stage was refilled before every warp had copied it"
        ring[slot] = (chunk, box(la, chunk), box(bb, chunk))
        full[slot].complete_tx(box_bytes)

    def read_store(entry):
        tile_index, chunk = entry
        at = _c(k.store_at, c0=c0, i=chunk, kSteps=steps, bi=bi)
        t0 = at[1]
        tile = staging[tile_index]
        n, m = min(steps, s - t0), min(lanes, w - c0)
        h_all[bi, t0:t0 + n, c0:c0 + m] = tile[:n, :m]   # TMA clips the box

    def producer():
        for i in range(chunks):
            slot = _c(k.slot, i=i, stages=stages)
            if i >= stages and not skip_empty_wait:
                parity = _c(k.empty_parity, i=i, stages=stages)
                while not empty[slot].try_wait(parity):
                    yield
            full[slot].arrive(tx=box_bytes)
            inflight.append((slot, i))
            yield

    def consumers_sync():
        gen = sync["generation"]
        sync["arrived"] += 1
        if sync["arrived"] == warps:
            sync["arrived"], sync["generation"] = 0, gen + 1
        while sync["generation"] == gen:
            yield

    def consumer(warp):
        mine = np.arange(warp * 32, min(warp * 32 + 32, lanes))
        live = (c0 + mine) < w
        h = np.zeros(len(mine), np.float32)
        h[live] = h0[bi, c0 + mine[live]]
        for i in range(chunks):
            slot = _c(k.slot, i=i, stages=stages)
            parity = _c(k.full_parity, i=i, stages=stages)
            while not full[slot].try_wait(parity):
                yield
            assert ring[slot] is not None and ring[slot][0] == i, \
                f"stage {slot} does not hold chunk {i}"
            _, a_box, b_box = ring[slot]
            a, x = a_box[:, mine].copy(), b_box[:, mine].copy()
            copied[warp] = i
            empty[slot].arrive()
            yield
            t_idx = _c(k.tile, i=i)
            assert all(e[0] != t_idx for e in unread), \
                "a staging tile was written before its store read it"
            if staging[t_idx] is None:
                staging[t_idx] = np.zeros((steps, lanes), np.float32)
            for t in range(steps):
                h = (np.exp(a[t]) * h + x[t]).astype(np.float32)
                staging[t_idx][t, mine] = h
                step, cols = i * steps + t, c0 + mine[live]
                if step < s:       # once, and after the step before it
                    assert (folded[bi, step, cols] == 0).all()
                    assert step == 0 or (folded[bi, step - 1, cols] == 1).all()
                    folded[bi, step, cols] += 1
            yield from consumers_sync()
            if warp == 0:
                unread.append((t_idx, i))
                while len(unread) > k.stores_pending:
                    yield
            yield from consumers_sync()
        h_last[bi, c0 + mine[live]] = h[live]
        if warp == 0:
            while unread:
                yield

    agents = [producer()] + [consumer(v) for v in range(warps)]
    budget = 400 * (chunks + 1) * (warps + 2)
    while agents or inflight or unread:
        budget -= 1
        assert budget > 0, "the emulated block deadlocked"
        moves = len(agents) + len(inflight) + len(unread)
        pick = int(rng.integers(moves))
        if pick < len(agents):
            try:
                next(agents[pick])
            except StopIteration:
                agents.pop(pick)
        elif pick < len(agents) + len(inflight):
            land(inflight.pop(pick - len(agents)))
        else:
            read_store(unread.pop(0))     # a thread's bulk stores in order


def emulate(la, bb, h0, plan, *, seed=0, skip_empty_wait=False):
    """The kernel's (h_all, h_last) for numpy (B, S, W) inputs under
    ``plan``, and how often each (batch, step, channel) was folded."""
    b, s, w = la.shape
    h_all = np.full((b, s, w), np.nan, np.float32)
    h_last = np.full((b, w), np.nan, np.float32)
    folded = np.zeros((b, s, w), np.int64)
    rng = np.random.default_rng(seed)
    for bi in range(plan.grid[1]):
        for bx in range(plan.grid[0]):
            _emulate_block(la, bb, h0, h_all, h_last, folded, plan, bi, bx,
                           rng, skip_empty_wait)
    return h_all, h_last, folded


def _inputs(rng, b, s, w):
    la = -np.exp(rng.standard_normal((b, s, w))).astype(np.float32)
    bb = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return la, bb, h0


# (B, S, W) with a ragged last stage and a ragged last tile, under the
# plan for a 132-SM card (32-channel tiles, one consumer warp) and for a
# 4-SM one (128-channel tiles, four consumer warps and a two-stage ring).
EMULATED = [((2, 1000, 200), H100_SMS), ((2, 1000, 200), 4)]


@pytest.mark.parametrize("shape,sms", EMULATED)
def test_emulated_stage_order_matches_plain_and_pallas(shape, sms):
    rng = np.random.default_rng(3)
    b, s, w = shape
    la, bb, h0 = _inputs(rng, b, s, w)
    plan = trg._plan(b, s, w, sms=sms)
    assert s % trg.STEPS and w % plan.lanes        # both edges ragged
    got_all, got_last, folded = emulate(la, bb, h0, plan, seed=sms)
    assert (folded == 1).all()
    want_all, want_last = trg.rglru_scan_plain(
        torch.from_numpy(la), torch.from_numpy(bb), torch.from_numpy(h0))
    np.testing.assert_allclose(got_all, want_all.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_last, want_last.numpy(), rtol=TOL,
                               atol=TOL)
    chunk = 256
    pad = (-s) % chunk                  # zero steps: identity steps
    pal_all, pal_last = rglru_scan_blocked(
        jnp.pad(la, ((0, 0), (0, pad), (0, 0))),
        jnp.pad(bb, ((0, 0), (0, pad), (0, 0))), jnp.asarray(h0),
        chunk=chunk, block_w=w, interpret=True)
    np.testing.assert_allclose(got_all, np.asarray(pal_all)[:, :s],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_last, np.asarray(pal_last), rtol=TOL,
                               atol=TOL)


def test_emulated_plans_take_the_kernels_tiles():
    assert trg._plan(2, 1000, 200, sms=H100_SMS).lanes == 32
    plan = trg._plan(2, 1000, 200, sms=4)
    assert (plan.lanes, plan.stages) == (128, 2)


def test_emulated_ring_without_the_empty_wait_breaks():
    rng = np.random.default_rng(4)
    la, bb, h0 = _inputs(rng, 1, 700, 64)
    plan = trg._plan(1, 700, 64, sms=H100_SMS)._replace(stages=2)
    emulate(la, bb, h0, plan)              # sound with the wait
    # The refill lands on a stage not yet copied, or arrives on a full
    # barrier whose phase is still open.
    with pytest.raises(AssertionError,
                       match="refilled before|more arrivals than"):
        emulate(la, bb, h0, plan, skip_empty_wait=True)


def test_emulation_reads_the_kernels_parities():
    # The full barrier of slot i % R completes once per pass over the
    # ring: chunk i waits for phase i / R; the producer's refill of chunk
    # i waits for the consumers' release of chunk i - R.
    k = _Kernel
    for i in range(12):
        assert _c(k.slot, i=i, stages=3) == i % 3
        assert _c(k.full_parity, i=i, stages=3) == (i // 3) & 1
        if i >= 3:
            assert _c(k.empty_parity, i=i, stages=3) == (i // 3 - 1) & 1
    assert _c(k.empty_count, L=128) == 4 and _c(k.empty_count, L=32) == 1
    assert k.steps == trg.STEPS
