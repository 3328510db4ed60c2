"""Perf hillclimbing driver (the port of ``repro.launch.hillclimb``).

Runs the reference's iterations on its selected (arch x shape) cells:
each ITERATIONS entry is one hypothesis -> change; the driver traces the
changed cell again (``launch.dryrun.run_cell``) and appends the before
and after roofline terms to ``artifacts/torch/hillclimb.json``. The
baselines are the untagged dry-run artifacts, so run the dry run first.
The cells, tags and changes are the reference's; the hypotheses are
stated without the reference's TPU numbers, and every before and after
number is the port's own dry-run terms on the H100's constants.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.dryrun import ARTIFACTS, run_cell
from repro_torch.launch.report import limit_s
from repro_torch.sharding import rules as shrules

OUT = Path(__file__).resolve().parents[3] / "artifacts" / "torch" \
    / "hillclimb.json"

# Each entry: (arch, shape, tag, hypothesis, kwargs for run_cell)
ITERATIONS = [
    # ---- deepseek-7b train_4k -------------------------------------------
    ("deepseek-7b", "train_4k", "blocked-attn",
     "Reference attention materialises float32 S^2 scores, most of the "
     "step's HBM traffic. Blocked (flash-style) attention keeps scores in "
     "a tile's working set: the memory term should fall several-fold; the "
     "collective term is unchanged.",
     dict(impl="blocked")),
    ("deepseek-7b", "train_4k", "blocked+fsdp",
     "Most collective bytes are the Megatron row-parallel activation "
     "all-reduces. A 7B model fits a card without TP: pure-FSDP parameter "
     "rules (params gathered per layer) should cut the collective term to "
     "the ZeRO-3 weight-gather floor.",
     dict(impl="blocked", rules="fsdp")),
    ("deepseek-7b", "train_4k", "blocked+fsdp+mb2",
     "With scores gone, activations are small; halving microbatches 4->2 "
     "halves the per-step weight re-gathers (gathers run per microbatch) "
     "at twice the activation memory.",
     dict(impl="blocked", rules="fsdp", overrides={"microbatches": 2})),
    ("deepseek-7b", "train_4k", "blocked+dp256",
     "Changing only the parameter rules leaves the activation TP splits "
     "in place, so the row-parallel all-reduces survive. Switch the "
     "ACTIVATION rules to pure data parallelism (batch over data x model "
     "= 256-way, hidden dims whole): the all-reduces become ZeRO weight "
     "gathers, a few times the model's bytes a microbatch.",
     dict(impl="blocked", act_rules="fsdp_acts")),
    ("deepseek-7b", "train_4k", "blocked+dp256+mb2",
     "ZeRO gathers repeat per microbatch; mb 4->2 halves them. Activation "
     "memory doubles but each rank holds only 1-2 sequences.",
     dict(impl="blocked", act_rules="fsdp_acts",
          overrides={"microbatches": 2})),

    # ---- qwen3-moe-235b train_4k ----------------------------------------
    ("qwen3-moe-235b-a22b", "train_4k", "blocked-attn",
     "Attention scores are a large share of the HBM traffic (94 layers x "
     "1M tokens); blocked attention removes them: the memory term falls.",
     dict(impl="blocked")),
    ("qwen3-moe-235b-a22b", "train_4k", "blocked+mb2",
     "Most all-gather bytes are the FSDP re-gathers of expert weights, "
     "repeated per microbatch (8x). mb 8->2 divides the gather traffic by "
     "4; activation memory grows 4x (it fits once scores are gone).",
     dict(impl="blocked", overrides={"microbatches": 2})),
    ("qwen3-moe-235b-a22b", "train_4k", "blocked+mb2+cf1",
     "capacity_factor 1.25 -> 1.0 cuts the expert dispatch buffers, "
     "all-to-all bytes and expert FLOPs by 20% at the cost of more "
     "dropped tokens (a quality tradeoff, not free).",
     dict(impl="blocked", overrides={"microbatches": 2,
                                     "moe": {"capacity_factor": 1.0}})),

    # ---- recurrentgemma-2b prefill_32k ----------------------------------
    ("recurrentgemma-2b", "prefill_32k", "local-attn",
     "The reference path materialises full 32k x 32k scores even for "
     "window-2048 layers, most of the traffic and the memory term's "
     "driver; chunked local attention is O(S x 2W): the memory term and "
     "the footprint a rank collapse.",
     dict(impl="blocked")),
    ("recurrentgemma-2b", "prefill_32k", "local-attn+chunked-scan",
     "The associative scan materialises O(S x W) per level across 32k "
     "steps; a chunked scan (1k-chunks) bounds the working set and its "
     "HBM traffic.",
     dict(impl="blocked", overrides={"recurrent": {"scan_impl": "chunked"}})),
    ("recurrentgemma-2b", "prefill_32k", "local-attn+chunked-block",
     "If the footprint does not move with the chunked scan, the float32 "
     "conv/gate/scan intermediates of the full 32k sequence come before "
     "the scan. Pipeline the WHOLE recurrent block (conv, gates, scan, "
     "out-proj) per 1k-chunk: the live set drops to O(B x chunk x W).",
     dict(impl="blocked",
          overrides={"recurrent": {"scan_impl": "chunked_block"}})),
    ("deepseek-7b", "train_4k", "blocked+zero16",
     "Keep the batch on data(16) (the baseline embedding path) but drop "
     "TP compute — activation rules ff/heads/kv -> None, vocab stays on "
     "model: ZeRO weight gathers over the model axis replace the "
     "row-parallel activation all-reduces.",
     dict(impl="blocked", act_rules="zero16")),
    ("deepseek-7b", "train_4k", "blocked+zero16+mb2",
     "ZeRO gathers repeat per microbatch: mb 4->2 halves the gather "
     "traffic; activations double.",
     dict(impl="blocked", act_rules="zero16",
          overrides={"microbatches": 2})),
    ("deepseek-7b", "train_4k", "blocked+dp256v2",
     "A batch on data(16) only gives each rank 16x the per-token work: "
     "TP-free layouts need the batch across ALL 256 ranks. Use dp256 with "
     "the embedding table and lm_head REPLICATED (their bytes are "
     "affordable), so the embedding lookup runs locally; expect the "
     "compute term back at the TP baseline's and the collective term at "
     "the ZeRO weight-gather floor.",
     dict(impl="blocked", rules="dp256v2", act_rules="fsdp_acts")),
    ("deepseek-7b", "train_4k", "blocked+dp256v2+mb2",
     "Halve the per-step ZeRO gather repetitions: mb 4->2.",
     dict(impl="blocked", rules="dp256v2", act_rules="fsdp_acts",
          overrides={"microbatches": 2})),
    ("qwen1.5-110b", "train_4k", "blocked+dp256+mb1",
     "(4th cell.) The baseline is memory-bound on attention scores with "
     "TP all-reduces close behind, and the all-reduce volume does not "
     "change with the microbatches. The deepseek-winning recipe at 110B: "
     "256-way DP + ZeRO gathers (3 passes of the bf16 weights a rank), "
     "blocked attention and mb1 (1 sequence a rank): compute should "
     "become the bottleneck.",
     dict(impl="blocked", rules="dp256v2", act_rules="fsdp_acts",
          overrides={"microbatches": 1})),
    ("recurrentgemma-2b", "prefill_32k", "local-attn-scan+chunked-block",
     "If the footprint still does not move, the residual is the LOCAL-"
     "ATTENTION path materialising every chunk's (B, W, 2W, H) float32 "
     "logits at once. Scan the local attention over chunks: the live set "
     "drops to one chunk.",
     dict(impl="blocked",
          overrides={"recurrent": {"scan_impl": "chunked_block"}})),
    ("deepseek-7b", "train_4k", "blocked+dp256+mb1",
     "dp256v2 at mb=4 holds 256/4 = 64 sequences a microbatch, which "
     "cannot split 256 ways, so the 256-way batch split degrades. With "
     "microbatches=1 the full 256-sequence batch splits exactly 256 "
     "ways (1 sequence a rank fits with blocked attention): the compute "
     "term back at the TP baseline's, the collective term at the "
     "ZeRO-gather floor.",
     dict(impl="blocked", rules="dp256v2", act_rules="fsdp_acts",
          overrides={"microbatches": 1})),
]


FSDP_RULES = {
    # Pure-FSDP parameter rules: everything sharded over the data axes,
    # no tensor parallelism (7B fits per-chip activations-wise).
    "embed": "data", "ff": "model", "heads": None, "kv_heads": None,
    "heads_flat": None, "head_dim": None, "vocab": "model",
    "experts": "model", "layers": None, None: None,
}

DP256V2_RULES = {
    # ZeRO params (2D-sharded, gathered at use) with a fully REPLICATED
    # embedding table (vocab AND embed_table unsharded) so the 256-way
    # batch embedding gather lowers locally.
    "embed": "data", "embed_table": None, "ff": "model", "heads": "model",
    "kv_heads": "model", "heads_flat": "model", "head_dim": None,
    "vocab": None, "experts": "model", "layers": None, None: None,
}

PARAM_RULE_SETS = {"fsdp": FSDP_RULES, "dp256v2": DP256V2_RULES}
ACT_RULE_SETS = {"fsdp_acts": shrules.FSDP_ACT_RULES,
                 "zero16": shrules.ZERO16_ACT_RULES}


def resolve(kw: dict) -> dict:
    """An iteration's ``run_cell`` kwargs with its rule-set names
    replaced by the rule sets."""
    kw = dict(kw)
    if isinstance(kw.get("rules"), str):
        kw["rules"] = PARAM_RULE_SETS[kw["rules"]]
    if isinstance(kw.get("act_rules"), str):
        kw["act_rules"] = ACT_RULE_SETS[kw["act_rules"]]
    return kw


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None, help="substring filter on tag")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device of the dry run's fake tensors")
    args = ap.parse_args(argv)

    results = []
    if OUT.exists():
        results = json.loads(OUT.read_text())
    done = {(r["arch"], r["shape"], r["tag"]) for r in results}

    for arch, shape, tag, hypothesis, kw in ITERATIONS:
        if args.only and args.only not in tag:
            continue
        if (arch, shape, tag) in done:
            print(f"[skip] {arch}/{shape}/{tag}")
            continue
        base_rec = json.loads(
            (ARTIFACTS / f"{arch}__{shape}__16x16.json").read_text())
        base = base_rec["roofline"]
        print(f"[run ] {arch}/{shape}/{tag}", flush=True)
        rec = run_cell(arch, shape, multi_pod=False, tag=tag,
                       device_type=args.device, **resolve(kw))
        after = rec["roofline"]
        row = {
            "arch": arch, "shape": shape, "tag": tag,
            "hypothesis": hypothesis,
            "before": base, "after": after,
            "before_kernelized": base_rec.get("roofline_kernelized"),
            "after_kernelized": rec.get("roofline_kernelized"),
            "score_bytes_after": rec.get("score_bytes_per_device"),
            "mem_gib_before":
            base_rec["memory"].get("bytes_per_device", 0) / 2 ** 30,
            "mem_gib_after":
            rec["memory"].get("bytes_per_device", 0) / 2 ** 30,
            "trace_s": rec["trace_s"], "splits": rec["splits"],
        }
        results.append(row)
        OUT.parent.mkdir(parents=True, exist_ok=True)
        OUT.write_text(json.dumps(results, indent=1))
        print(f"       bottleneck {limit_s(base):.4f}s -> "
              f"{limit_s(after):.4f}s "
              f"(compute {after['compute_s']:.4f} memory "
              f"{after['memory_s']:.4f} collective "
              f"{after['collective_s']:.4f})", flush=True)


if __name__ == "__main__":
    main()
