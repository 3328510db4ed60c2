"""The generator, the sample, the trace's arithmetic and the readers, on
made-up inputs."""
import re
import types

import numpy as np
import pytest

from chipbench import check
from chipbench.manifest import load_cell, reader
from chipbench.peaks import PEAKS
from chipbench.trace import Trace
from chipbench.traffic import Traffic

H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def test_traffic_is_the_seeds_and_padded_as_the_engine_pads():
    # Every prompt fills the engine's slot width, so nothing is padded.
    spec = {"batch": 3, "prompt_len": 9, "new_tokens": 2}
    a, b = Traffic(spec, 100, 2**33 + 1), Traffic(spec, 100, 2**33 + 1)
    c = Traffic(spec, 100, 2**33 + 2)
    pa = a.prompts("window", 5)
    assert pa.shape == (3, 9) and pa.dtype == np.int32
    assert np.array_equal(pa, b.prompts("window", 5))
    assert not np.array_equal(pa, c.prompts("window", 5))
    assert not np.array_equal(pa, a.prompts("window", 6))
    assert pa.min() >= 0 and pa.max() < 100
    for bad in ([4, 9], 0):
        with pytest.raises(ValueError):
            Traffic(dict(spec, prompt_len=bad), 100, 1)


def _batches(sizes):
    return [types.SimpleNamespace(index=i, ok=[True] * n)
            for i, n in enumerate(sizes)]


def test_pick_takes_the_longest_and_whole_batches_where_coupled():
    b = _batches([3, 3, 3, 3])
    got = check.pick(b, 4, False, 3)
    assert sum(map(len, got.values())) == 4
    assert check.pick(b, 4, False, 3) == got
    assert check.pick(b, 4, False, 4) != got
    whole = check.pick(b, 4, True, 3)
    assert all(rows == [0, 1, 2] for rows in whole.values())
    assert len(whole) == 2
    assert sum(map(len, check.pick(b, 100, False, 3).values())) == 12
    b[2].ok[1] = False
    assert (2, 1) not in {(i, r) for i, rows in
                          check.pick(b, 100, False, 3).items() for r in rows}


def test_readings_gap_and_error():
    import torch
    ref = torch.tensor([[[0.0, 3.0, 1.0, 2.0]]])
    vals = torch.tensor([[[2.5, 2.0]]])
    idx = torch.tensor([[[1, 3]]])
    got = check.readings(ref, np.array([[3]]), vals, idx)
    assert got == {"token_gap": 1.0, "logit_err": 0.5}


def test_trace_union_window_and_breakdown():
    ops = [("k1", 100, 200), ("k2", 150, 300), ("k3", 400, 450),
           ("flash_attention_wgmma_kernel<80>", 500, 600)]
    host = (np.array([50, 290, 295]), np.array([700, 390, 330]),
            ["aten::a", "cudaLaunchKernel", "aten::inner"])
    tr = Trace(ops, {"chipbench.tail": [(50, 650)],
                     "chipbench.prefill": [(90, 610)]}, host, 50, 650)
    assert tr.window_s == pytest.approx(600e-9)
    assert tr.busy_s == pytest.approx(350e-9)
    assert len(tr.ops_in("chipbench.prefill", re.compile("flash"))) == 1
    br = tr.breakdown()
    assert br["device_ops"][0][0] == "k2"
    labels = dict(br["idle_gaps"])
    assert labels["chipbench.prefill aten::inner"] == pytest.approx(100e-9)
    assert labels["outside spans aten::a"] == pytest.approx(50e-9)
    assert sum(labels.values()) == pytest.approx(250e-9)


def _run(cell_name, ops, spans):
    cell = load_cell(cell_name)
    t = Traffic(cell.traffic, cell.config["arch"]["vocab_size"], 1)
    tr = Trace(ops, spans, (np.zeros(0), np.zeros(0), []), 0, 10**9)
    return types.SimpleNamespace(arch=cell.config["arch"], traffic=t,
                                 reference=cell.reference(), peaks=H100,
                                 trace=tr)


def test_flash_roofline_bound_is_the_kernel_tables():
    # Batch 8 of 4096: twice the kernel table's (4, 4096, 32, 80) bound
    # of 0.3475 ms; two launches of 2 x 1.433 ms read its 24.25%.
    ms = 1e6
    ops = [("void flash_attention_wgmma_kernel<80>(...)", 0, int(2.866 * ms)),
           ("void flash_attention_wgmma_kernel<80>(...)", int(3 * ms),
            int(3 * ms + 2.866 * ms)), ("other", 0, 10)]
    run = _run("stablelm-3b.score-4k", ops,
               {"chipbench.prefill": [(0, 10**8)]})
    got = reader("flash_roofline")(run)
    assert got == pytest.approx(100 * 0.3475038116885743 / 1.433, rel=1e-3)
    run.trace.spans = {"chipbench.prefill": [(10**8, 10**9)]}
    assert reader("flash_roofline")(run) is None


def test_gmm_roofline_bound_is_the_kernel_tables():
    ops = [("gmm_wgmma_kernel", 0, 1_266_302)]
    run = _run("deepseek-moe-16b.score-512", ops,
               {"chipbench.prefill": [(0, 10**8)]})
    got = reader("gmm_roofline")(run)
    assert got == pytest.approx(100 * 0.7165516722345804 / 1.266302,
                                rel=1e-4)
    run.trace.ops = [("sm90_xmma_gemm_bf16", 0, 100)]
    assert reader("gmm_roofline")(run) is None
