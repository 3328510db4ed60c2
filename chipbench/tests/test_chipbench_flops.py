"""The model-FLOP count of each configuration against sums worked by hand
from its published widths, and the kernels' bounds the roofline readers
use against the kernel table's (PERF.md)."""
import pytest

from chipbench.manifest import load_cell

STABLELM = load_cell("stablelm-3b.score-4k")
DEEPSEEK = load_cell("deepseek-moe-16b.score-512")


def test_stablelm_matmul_flops_a_token():
    # 32 layers x (4 x 2560^2 attention + 3 x 2560 x 6912 SwiGLU) x 2.
    ref = STABLELM.reference()
    assert ref.matmul_flops_per_token(STABLELM.config["arch"]) == \
        2 * 32 * (4 * 2560 * 2560 + 3 * 2560 * 6912) == 5_075_107_840


def test_deepseek_moe_matmul_flops_a_token():
    # Layer 0: attention + SwiGLU 10944. Layers 1-27: attention, router
    # 2048 x 64, 6 routed experts and the shared pair (3 x 2048 x 2816).
    ref = DEEPSEEK.reference()
    attn = 4 * 2048 * 2048
    dense = attn + 3 * 2048 * 10944
    moe = attn + 2048 * 64 + 3 * 2048 * (6 * 1408 + 2816)
    assert ref.matmul_flops_per_token(DEEPSEEK.config["arch"]) == \
        2 * (dense + 27 * moe) == 4_818_206_720


def test_prompt_flops_of_a_stablelm_4k_batch():
    ref, a = STABLELM.reference(), STABLELM.config["arch"]
    band = 4 * 32 * 32 * 80 * 4096 * 4097 // 2
    head = 2 * 2560 * 50304
    assert ref.attention_flops(a, 4096) == band
    assert ref.prompt_flops(a, 4096) == 5_075_107_840 * 4096 + band + head
    batch = 8 * ref.prompt_flops(a, 4096)
    assert batch == pytest.approx(1.883e14, rel=1e-3)
    # Causal attention is about an eighth of the work at 4,096 tokens.
    assert 0.11 < 8 * band / batch < 0.13


def test_moe_capacity_of_both_cells():
    ref, mo = DEEPSEEK.reference(), DEEPSEEK.config["arch"]["moe"]
    assert ref.capacity(mo, 32 * 512) == ref.capacity(mo, 4 * 4096) == 1920
    assert ref.capacity(mo, 32) == 4 and ref.capacity(mo, 4) == 1
