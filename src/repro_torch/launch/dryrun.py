"""Multi-pod dry run: every (arch x shape x mesh) cell traced as one rank
of the production world (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step for 256 or 512
placeholder CPU devices and reads the per-device SPMD module. The port
runs the same step as rank 0 of a fake world instead:

  1. ``launch.mesh.fake_world(256 | 512)``: this process as rank 0 on
     PyTorch's fake backend, whose collectives move nothing, and the
     production mesh (16x16, or 2x16x16 with a ``"pod"`` axis) over it;
  2. the model (``init_model(..., mesh=, rules=)``), the AdamW state, the
     inputs (``launch.inputs.input_specs``' shapes; a decode cell's
     caches in ``steps.cache_shardings``' layout, at a rank's shapes) as
     fake tensors on the card (``FakeTensorMode``: nothing is allocated);
  3. the step (``make_train_step`` / ``make_prefill_step`` /
     ``make_decode_step`` by the shape's kind) run once under
     ``trace_analysis.trace``: FLOPs, bytes, collectives, peak memory;
  4. the roofline terms on the H100 (``launch.roofline``) into
     ``artifacts/torch/dryrun/<arch>__<shape>__<mesh>.json``.

Rank 0 stands for every rank, as the per-device module does in the
reference: each split divides evenly or is dropped for every rank alike
(``rules.pspec_for``'s degradation), and the record lists the logical
axes that the rules put on ``"model"`` but that stay whole
(``splits``).

Trip counts. The reference scans its layers and microbatches, and its
HLO analysis multiplies each loop body by its trip count. The port's
loops are Python loops, unrolled in a trace, and a fake op costs about
0.3 ms of host time, so a 94-layer model with 8 microbatches would take
minutes a cell. Every count is affine in the repeats of a segment's unit
(each repeat runs the same ops on the same shapes) and in the
microbatches (each runs the same ops; the float32 accumulation starts
at the second), so the dry run traces the main segment at 2 and 3
repeats and the step at 2 and 3 microbatches (at the microbatch's real
rows), and extrapolates each count to the full depth and microbatches,
bilinearly (``while_trip_counts`` holds the full trip counts, ``traced``
the points). Cells with at most 3 repeats and 3 microbatches are traced
whole. The peak memory is extrapolated the same way (the parameters,
optimizer state and saved activations grow with the depth; the working
set of one layer does not).

The kernels are not traced: ``impl`` is ``"reference"`` (or
``"blocked"``) and no port kernel can launch on fake tensors, as the
reference's dry run lowers no Pallas kernel. ``roofline_kernelized``
credits flash attention with the score tensors' bytes, as the
reference's ``_kernelized`` does.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod|--both] \\
      [--skip-existing] [--device cpu] [--jobs N]

``--jobs N`` traces N cells at once, each in a process of its own; the
command exits 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import SHAPES, ShapeConfig, shape_applicable
from repro_torch.configs.registry import ASSIGNED, get_arch
from repro_torch.core.device import resolve_device
from repro_torch.launch import inputs, roofline, steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import trace_analysis
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache
from repro_torch.sharding import rules as shrules
from repro_torch.train import optimizer as opt_mod

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "torch" \
    / "dryrun"
NA_REASON = ("full-attention arch; long_500k requires sub-quadratic "
             "attention (DESIGN.md #4)")
# The repeats and microbatches a cut trace runs at (two points a loop).
CUT_POINTS = (2, 3)


def cell_name(arch: str, shape: str, multi_pod: bool) -> str:
    mesh = "2x16x16" if multi_pod else "16x16"
    return f"{arch}__{shape}__{mesh}"


def with_overrides(cfg, overrides: Optional[dict]):
    """``cfg`` with the reference's ``overrides`` (``recurrent`` and
    ``moe`` as dicts of their fields)."""
    if not overrides:
        return cfg
    over = dict(overrides)
    if "recurrent" in over and cfg.recurrent is not None \
            and isinstance(over["recurrent"], dict):
        over["recurrent"] = dataclasses.replace(cfg.recurrent,
                                                **over["recurrent"])
    if "moe" in over and cfg.moe is not None \
            and isinstance(over["moe"], dict):
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    return dataclasses.replace(cfg, **over)


# ---------------------------------------------------------------------------
# Trip counts
# ---------------------------------------------------------------------------

def _main_segment(segs) -> int:
    return max(range(len(segs)), key=lambda i: segs[i][1])


def _at_repeats(cfg, r: int):
    """``cfg`` with its main segment repeated ``r`` times (the other
    segments as they are), or None where the layer pattern does not cut
    so."""
    segs = tfm.compute_segments(cfg)
    s = _main_segment(segs)
    unit, repeats = segs[s]
    cut = dataclasses.replace(
        cfg, num_layers=cfg.num_layers - (repeats - r) * len(unit))
    want = [(u, r if i == s else n) for i, (u, n) in enumerate(segs)]
    return cut if tfm.compute_segments(cut) == want else None


def trip_plan(cfg, shape: ShapeConfig):
    """([(cfg, shape, weight)], trip counts): the traces to run and each
    one's weight in the extrapolated counts (Lagrange weights of the
    two points of each cut loop; 1 for a loop traced whole)."""
    segs = tfm.compute_segments(cfg)
    repeats = segs[_main_segment(segs)][1]
    micro = cfg.microbatches if shape.kind == "train" else 1
    lo, hi = CUT_POINTS
    r_points = [(repeats, 1)]
    if repeats > hi and all(_at_repeats(cfg, r) is not None
                            for r in CUT_POINTS):
        r_points = [(lo, hi - repeats), (hi, repeats - lo)]
    m_points = [(micro, 1)]
    if micro > hi:
        m_points = [(lo, hi - micro), (hi, micro - lo)]
    plan = []
    for r, wr in r_points:
        c = cfg if r == repeats else _at_repeats(cfg, r)
        for m, wm in m_points:
            rows = shape.global_batch // micro
            sh = shape if m == micro else dataclasses.replace(
                shape, global_batch=rows * m)
            plan.append((dataclasses.replace(c, microbatches=m)
                         if shape.kind == "train" else c, sh, wr * wm))
    return plan, [repeats, micro]


def _combine(summaries, weights):
    """The weighted sum of each count of ``summaries``."""
    def mix(values):
        if any(isinstance(v, dict) for v in values):
            values = [v if isinstance(v, dict) else {} for v in values]
            keys = sorted(set().union(*values))
            return {k: mix([v.get(k, 0) for v in values]) for k in keys}
        return sum(w * v for w, v in zip(weights, values))
    fields = dataclasses.fields(trace_analysis.TraceSummary)
    out = {f.name: mix([getattr(s, f.name) for s in summaries])
           for f in fields if f.name != "while_trip_counts"}
    return trace_analysis.TraceSummary(while_trip_counts=[], **out)


# ---------------------------------------------------------------------------
# One trace
# ---------------------------------------------------------------------------

def _zero_batch(cfg, shape: ShapeConfig, device) -> dict:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in inputs.batch_specs(cfg, shape).items()}


def _full_caches(cfg, shape: ShapeConfig, mesh, act_rules, device) -> list:
    """A rank's decode caches, full (``length`` = S - 1): each leaf of
    ``transformer.init_cache`` (what ``launch.inputs.cache_specs``
    stacks into the reference's segments) at its local shape under
    ``steps.cache_shardings``."""
    whole = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                           cfg.activation_dtype, device="meta")
    specs = steps.cache_shardings(whole, mesh, act_rules)
    out = []
    for node, spec in zip(whole, specs):
        if isinstance(node, KVCache):
            size = node.k.shape[1]
            k, v = (torch.zeros(steps.local_shape(t.shape, sp, mesh),
                                dtype=t.dtype, device=device)
                    for t, sp in ((node.k, spec.k), (node.v, spec.v)))
            out.append(KVCache(k, v, min(shape.seq_len - 1, size),
                               size if spec.k[1] == "model" else 0))
            continue
        out.append(type(node)(*(
            torch.zeros(steps.local_shape(t.shape, sp, mesh),
                        dtype=t.dtype, device=device)
            for t, sp in zip(node, spec))))
    return out


def build_step(cfg, shape: ShapeConfig, mesh, *, rules=None,
               act_rules=None, impl: str = "reference", device,
               cache_len: Optional[int] = None,
               opt_cfg: opt_mod.AdamWConfig = opt_mod.AdamWConfig(),
               seed: int = 0):
    """The cell's step and its arguments on ``device``: the model
    (``init_model`` from a seeded generator, laid out by ``rules``), the
    AdamW state, the batch (zeros of ``input_specs``' shapes; every rank
    passes the global batch), a decode cell's caches (full, in
    ``cache_shardings``' layout). Under ``FakeTensorMode`` everything is
    fake; outside it, real (the runs the dry run is held against)."""
    act_rules = act_rules or shrules.activation_rules(mesh)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = tfm.init_model(cfg, gen, dtype=cfg.activation_dtype, mesh=mesh,
                           rules=rules)
    if shape.kind == "train":
        opt = opt_mod.init_opt_state(model, opt_cfg)
        step = steps.make_train_step(
            cfg, opt_cfg, impl, mesh=mesh, rules=rules, act_rules=act_rules,
            global_batch=shape.global_batch)
        return step, (model, opt, _zero_batch(cfg, shape, device))
    if shape.kind == "prefill":
        step = steps.make_prefill_step(cfg, cache_len or shape.seq_len,
                                       impl, mesh=mesh, act_rules=act_rules)
        return step, (model, _zero_batch(cfg, shape, device))
    tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32,
                         device=device)
    step = steps.make_decode_step(cfg, shape.global_batch, mesh=mesh,
                                  act_rules=act_rules)
    return step, (model, tokens,
                  _full_caches(cfg, shape, mesh, act_rules, device),
                  shape.seq_len - 1)


def _trace_once(cfg, shape: ShapeConfig, mesh, **kw):
    """One run of the cell's step on fake tensors, traced."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = build_step(cfg, shape, mesh, **kw)
        with trace_analysis.trace(mesh) as tr:
            tr.mode.track(list(args[0].parameters()), "params")
            if shape.kind == "train":
                tr.mode.track(args[1], "optimizer")
            tr.mode.track(args[2] if shape.kind == "train" else args[1:3],
                          "inputs")
            step(*args)
        return tr.summary()


def splits(cfg, shape: ShapeConfig, mesh, act_rules) -> dict:
    """The axes the step splits its batch over, and the logical axes the
    rules put on ``"model"`` that stay whole on every rank (their size
    does not divide, or the batch holds ``"model"``)."""
    rows = shape.global_batch // (cfg.microbatches
                                  if shape.kind == "train" else 1)
    axes = steps.batch_axes(cfg, mesh, shape.kind, rows, act_rules)
    sizes = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
             "ff": cfg.d_ff, "vocab": cfg.vocab_size}
    whole = []
    for axis, size in sizes.items():
        want = act_rules.get(axis)
        if "model" in (want if isinstance(want, tuple) else (want,)) and \
                not common.model_split(axis, size, rules=act_rules,
                                       mesh=mesh, split=axes):
            whole.append(axis)
    return {"batch_axes": list(axes), "whole_on_model": whole}


def trace_cell(cfg, shape: ShapeConfig, mesh, *, rules=None,
               act_rules=None, impl: str = "reference",
               device_type: str = "cuda", cache_len: Optional[int] = None,
               opt_cfg: opt_mod.AdamWConfig = opt_mod.AdamWConfig(),
               extrapolate: bool = True):
    """The cell's step as rank 0 of ``mesh`` (over a fake world, or any
    initialised group): (``TraceSummary`` per rank, info). Counts are
    extrapolated from cut traces (``trip_plan``) unless ``extrapolate``
    is false; ``cache_len`` is the prefill's cache length (the shape's
    sequence by default)."""
    device = resolve_device(device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    act_rules = act_rules or shrules.activation_rules(mesh)
    if extrapolate:
        plan, trips = trip_plan(cfg, shape)
    else:
        plan, trips = [(cfg, shape, 1)], []
    t0 = time.perf_counter()
    summaries = [_trace_once(c, sh, mesh, rules=rules, act_rules=act_rules,
                             impl=impl, device=device, cache_len=cache_len,
                             opt_cfg=opt_cfg)
                 for c, sh, _ in plan]
    summary = _combine(summaries, [w for _, _, w in plan])
    if len(plan) > 1:
        summary.while_trip_counts = trips
    info = {"trace_s": time.perf_counter() - t0,
            "traced": [{"num_layers": c.num_layers,
                        "microbatches": c.microbatches,
                        "global_batch": sh.global_batch, "weight": w}
                       for c, sh, w in plan],
            "device": str(device), "impl": impl,
            "splits": splits(cfg, shape, mesh, act_rules)}
    return summary, info


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def _memory_dict(summary, device) -> dict:
    tracked = summary.tracked_bytes
    out = {"bytes_per_device": summary.peak_bytes,
           "params_bytes": tracked.get("params", 0),
           "optimizer_bytes": tracked.get("optimizer", 0),
           "inputs_bytes": tracked.get("inputs", 0)}
    out["activations_and_temps_bytes"] = out["bytes_per_device"] - sum(
        tracked.values())
    if device.type == "cuda":
        out["total_memory"] = torch.cuda.get_device_properties(
            device).total_memory
        out["total_memory_source"] = torch.cuda.get_device_name(device)
    else:
        out["total_memory"] = roofline.H100_MEMORY_BYTES
        out["total_memory_source"] = "H100 SXM5 datasheet"
    return out


def record(cfg, shape: ShapeConfig, mesh, summary, info, *, name: str,
           tag: str = "") -> dict:
    """The reference's record of a cell, from its trace."""
    chips = mesh.size()
    mf = roofline.model_flops(cfg, shape)
    terms = roofline.roofline_terms_from_trace(summary, chips, mf)
    return {
        "cell": name, "status": "ok", "tag": tag, "arch": cfg.name,
        "shape": shape.name, "mesh": list(mesh.shape), "chips": chips,
        "trace_s": round(info["trace_s"], 1),
        "memory": _memory_dict(summary, torch.device(info["device"])),
        "flop_counter": {"flops": summary.dot_flops},
        "collectives": {"counts": summary.collective_counts,
                        "payload_bytes": summary.collective_payload,
                        "wire_bytes_per_device":
                        summary.collective_wire_bytes,
                        "while_trip_counts": summary.while_trip_counts,
                        "sent_bytes_by_kind": summary.collective_sent,
                        "wire_bytes_by_kind": summary.collective_wire,
                        "counts_by_axis": summary.collective_axis_counts,
                        "wire_bytes_by_axis": summary.collective_axis_wire},
        "roofline": terms.to_dict(),
        "roofline_kernelized": roofline.kernelized_terms(
            terms.to_dict(), summary.score_bytes),
        "score_bytes_per_device": summary.score_bytes,
        "params_total": roofline.count_params(cfg),
        "params_active": roofline.active_params(cfg),
        "traced": info["traced"], "ops": summary.ops,
        "device": info["device"], "impl": info["impl"],
        "splits": info["splits"],
    }


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
             rules=None, act_rules=None, out_dir: Path = ARTIFACTS,
             tag: str = "", impl: str = "reference",
             overrides: dict | None = None,
             device_type: str = "cuda") -> dict:
    cfg = with_overrides(get_arch(arch_name), overrides)
    shape = SHAPES[shape_name]
    name = cell_name(arch_name, shape_name, multi_pod)
    if not shape_applicable(cfg, shape):
        return {"cell": name, "status": "n/a", "reason": NA_REASON}
    with mesh_mod.fake_world(512 if multi_pod else 256):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                             device_type=device_type)
        summary, info = trace_cell(cfg, shape, mesh, rules=rules,
                                   act_rules=act_rules, impl=impl,
                                   device_type=device_type)
        rec = record(cfg, shape, mesh, summary, info, name=name, tag=tag)
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = name + (f"__{tag}" if tag else "") + ".json"
    (out_dir / fname).write_text(json.dumps(rec, indent=1))
    return rec


def _line(rec: dict) -> str:
    """A cell's line of the sweep's output."""
    if rec["status"] == "n/a":
        return f"[n/a ] {rec['cell']}: {rec['reason']}"
    if rec["status"] != "ok":
        return f"[FAIL] {rec['cell']}: {rec['error']}"
    r = rec["roofline"]
    return (f"[ ok ] {rec['cell']}: trace={rec['trace_s']}s "
            f"mem/dev={rec['memory']['bytes_per_device']/2**30:.2f}GiB "
            f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
            f"collective={r['collective_s']:.4f}s "
            f"bottleneck={r['bottleneck']}")


def _failed(name: str, error: str, tb: str) -> dict:
    return {"cell": name, "status": "failed", "error": error,
            "traceback": tb[-4000:]}


def _in_process(arch, shape, mp, device) -> dict:
    name = cell_name(arch, shape, mp)
    try:
        return run_cell(arch, shape, multi_pod=mp, device_type=device)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        return _failed(name, repr(e), traceback.format_exc())


def _in_subprocess(arch, shape, mp, device) -> dict:
    """One cell in a process of its own (``main`` on that cell alone);
    its record is the artifact it writes."""
    name = cell_name(arch, shape, mp)
    path = ARTIFACTS / (name + ".json")
    path.unlink(missing_ok=True)
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--device", device] + \
        (["--multi-pod"] if mp else [])
    out = subprocess.run(cmd, capture_output=True, text=True, env=env)
    if path.exists():
        return json.loads(path.read_text())
    return _failed(name, f"the cell's process exited {out.returncode} "
                   "without a record", out.stdout + out.stderr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true",
                    help="run single-pod and multi-pod meshes")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device of the fake tensors (cuda: the card "
                         "must be there)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (a trace is host-bound, one core each)")
    args = ap.parse_args(argv)

    cells = []
    archs = list(ASSIGNED) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = [False, True] if args.both else [args.multi_pod]
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                cells.append((arch, shape, mp))

    skipped = 0
    todo = []
    for arch, shape, mp in cells:
        path = ARTIFACTS / (cell_name(arch, shape, mp) + ".json")
        if args.skip_existing and path.exists():
            prev = json.loads(path.read_text())
            if prev.get("status") in ("ok", "n/a"):
                skipped += 1
                continue
        todo.append((arch, shape, mp))
    one = _in_subprocess if args.jobs > 1 else _in_process
    counts = {"ok": 0, "n/a": 0, "failed": 0}
    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        futures = [pool.submit(
            one if shape_applicable(get_arch(arch), SHAPES[shape])
            else _in_process, arch, shape, mp, args.device)
            for arch, shape, mp in todo]
        for fut in as_completed(futures):
            rec = fut.result()
            counts[rec["status"]] += 1
            if rec["status"] != "ok":
                ARTIFACTS.mkdir(parents=True, exist_ok=True)
                (ARTIFACTS / (rec["cell"] + ".json")).write_text(
                    json.dumps(rec, indent=1))
            print(_line(rec), flush=True)
    print(f"dryrun summary: ok={counts['ok']} n/a={counts['n/a']} "
          f"failed={counts['failed']} skipped={skipped}", flush=True)
    if counts["failed"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
