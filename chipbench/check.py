"""The comparison that decides ``correct``.

Once the window has closed and the program is freed, a sample of the
requests the window finished, drawn from the seed, is run through the
plain reference: its prompts, then the decode steps fed the tokens the
engine served. For
a configuration whose rows meet inside the model (an MoE's capacity is
worked out over the whole batch) the sample is of whole batches.

Two numbers are compared, each over every judged logit row: the prefill's
last slot and every decode step.

- ``token_gap``: how far below the reference's best logit the reference
  puts the token the program produced there (the served token; after the
  last decode step, whose token the engine drops, the step's argmax);
- ``logit_err``: the largest distance between the program's logit and
  the reference's, over the program's ``TOP`` highest logits a row.

The control puts the reference in float8 (``precision="fp8"``) in the
program's place: its first token and its highest logits on the same
prompts and tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from chipbench.weights import stream_seed

TOP = 8
# Prompt tokens a reference call takes at most, rows of independent
# requests grouped up to it.
CALL_TOKENS = 131072


def pick(batches: list, want: int, coupled: bool, seed: int) -> dict:
    """{batch index: [rows]} of finished requests to judge, at least
    ``want`` of them (all if fewer finished), in an order drawn from the
    seed; whole batches where ``coupled``. Every prompt has the cell's one
    length, so the sample holds the longest."""
    rng = np.random.default_rng(stream_seed(seed, "sample"))
    done = [(b.index, r) for b in batches
            for r in range(len(b.ok)) if b.ok[r]]
    out: dict = {}
    count = 0
    for j in rng.permutation(len(done)):
        i, r = done[j]
        if count >= want:
            break
        if coupled:
            if i in out:
                continue
            out[i] = [rr for ii, rr in done if ii == i]
            count += len(out[i])
        else:
            out.setdefault(i, []).append(r)
            count += 1
    return {i: sorted(rows) for i, rows in sorted(out.items())}


def _produced(served: np.ndarray, last_top1: np.ndarray) -> np.ndarray:
    """(R, 1 + T) tokens produced at each judged logit row: the served
    tokens, then the argmax of the last decode step."""
    return np.concatenate([served, last_top1[:, None]], 1)


def readings(ref_rows: torch.Tensor, produced: np.ndarray, top_vals,
             top_idx) -> dict:
    """token_gap and logit_err of one group of rows. ref_rows: (R, P, V)
    reference logits; produced: (R, P) tokens; top_vals, top_idx: (R, P,
    TOP) the judged side's highest logits."""
    tok = torch.as_tensor(produced, device=ref_rows.device).long()
    best = ref_rows.max(-1).values
    got = ref_rows.gather(-1, tok[..., None])[..., 0]
    at = ref_rows.gather(-1, top_idx.to(ref_rows.device).long())
    return {"token_gap": float((best - got).max()),
            "logit_err": float((top_vals.to(ref_rows.device) - at)
                               .abs().max())}


def _merge(acc: dict, new: dict) -> dict:
    return {k: max(acc.get(k, 0.0), v) for k, v in new.items()}


def judge(cell, arch: dict, weights, traffic, batches: list, seed: int,
          device, control: bool = False) -> dict:
    """The readings of the program's sampled requests against the
    reference (and, with ``control``, of the float8 reference against
    it): the two numbers, the requests and rows judged, and the routed
    assignments the reference dropped over capacity."""
    ref = cell.reference()
    want = int(cell.traffic["check"]["requests"])
    coupled = arch.get("moe") is not None
    picks = pick(batches, want, coupled, seed)
    by_index = {b.index: b for b in batches}
    groups, rows_per_call = [], max(1, CALL_TOKENS // traffic.prompt_len)
    for i, rows in picks.items():
        items = [(i, r) for r in rows]
        if coupled or not groups or \
                len(groups[-1]) + len(items) > rows_per_call:
            groups.append([])
        groups[-1].extend(items)
    prompts = {i: traffic.prompts("window", i) for i in picks}
    out = {"program": {}, "requests": 0, "rows": 0, "dropped": 0,
           "dropped_decode": 0}
    if control:
        out["control"] = {}
    for group in groups:
        if coupled:
            # The whole batch runs, as the engine routed it together.
            i = group[0][0]
            run_rows = list(range(traffic.batch))
            tokens = prompts[i]
            dec = by_index[i].decode_in
        else:
            run_rows = list(range(len(group)))
            tokens = np.stack([prompts[i][r] for i, r in group])
            dec = np.stack([by_index[i].decode_in[r] for i, r in group])
        t = torch.as_tensor(tokens, device=device)
        d = torch.as_tensor(dec, device=device)
        p_logits, d_logits, stats = ref.forward(arch, weights, t, d)
        ref_rows = torch.cat([p_logits[:, None], d_logits], 1)
        del p_logits, d_logits
        sel = [r for _, r in group] if coupled else run_rows
        ref_rows = ref_rows[sel]
        src = [by_index[i] for i, _ in group]
        rows = [r for _, r in group]
        served = np.stack([b.served[r] for b, r in zip(src, rows)])
        top_v = torch.stack([b.top_vals[r] for b, r in zip(src, rows)])
        top_i = torch.stack([b.top_idx[r] for b, r in zip(src, rows)])
        produced = _produced(served, top_i[:, -1, 0].cpu().numpy())
        out["program"] = _merge(out["program"],
                                readings(ref_rows, produced, top_v, top_i))
        out["requests"] += len(group)
        out["rows"] += ref_rows.shape[0] * ref_rows.shape[1]
        out["dropped"] += stats["dropped"]
        out["dropped_decode"] += stats["dropped_decode"]
        if control:
            c_p, c_d, _ = ref.forward(arch, weights, t, d, precision="fp8")
            c_rows = torch.cat([c_p[:, None], c_d], 1)[sel]
            del c_p, c_d
            c_top = c_rows.topk(TOP, dim=-1)
            out["control"] = _merge(out["control"], readings(
                ref_rows, c_top.indices[..., 0].cpu().numpy(),
                c_top.values, c_top.indices))
            del c_rows
        del ref_rows
    return out
