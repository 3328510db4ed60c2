#!/usr/bin/env bash
# One-command gate of the PyTorch/CUDA port: its tests (on the CPU, held
# against the JAX reference) and the regression gate over the port's
# bench results.
#
#   scripts/ci_torch.sh            # gate the committed BENCH_engine_torch.json
#   scripts/ci_torch.sh --run      # re-run the benchmarks first (needs the
#                                  # card), then gate
#
# The gate is the reference's (scripts/ci.sh): the same required
# sections, every recorded speedup >= 1.0 and within tolerance of the
# committed baseline, planning under 1% of a Q12 run, and the
# adaptive_chaos and fault_recovery p99 floors.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"

python -m pytest -q tests/test_torch_*.py

REQUIRED_SECTIONS="shuffle_elision,join_pipeline,dup_key_join,partition_fusion,pipeline,shuffle,concurrent_serving,tiered_exchange,adaptive_chaos,out_of_core,fault_recovery"
python -m repro_torch.bench.check_regression \
    --require-section "$REQUIRED_SECTIONS" "$@"

echo "ci_torch.sh: all gates green"
