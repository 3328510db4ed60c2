"""Step factories: train, prefill and decode (the port of
``repro.launch.steps``), with the sharding helpers.

The reference bound each step to a mesh and jit-compiled it with explicit
shardings. The port runs eagerly: each factory returns a plain closure.
Without a mesh it runs on the model's one device. With ``mesh`` (a
``DeviceMesh`` with the reference's axis names) every rank calls the
step with the whole global batch; the step keeps the rank's rows over
the axes ``batch_shardings`` puts the batch on (``(pod, data)`` where
the batch divides them, else ``data``, else none), pod-major as the
reference's ``NamedSharding`` lays them out, and the model's parameters
are DTensors placed by ``sharding.rules`` (``model_shardings``). Each
step installs its activation rules (``act_rules``: the reference's
``ACT_RULES`` on the mesh by default, or any rule set such as the
hillclimb's ``FSDP_ACT_RULES`` or ``ZERO16_ACT_RULES``), and the model
runs the tensor parallelism they give on ``"model"``. The serving steps
run under ``torch.inference_mode()`` and return the rank's rows of the
logits (gathered over the vocabulary) and its caches (laid out as
``cache_shardings`` gives); the train step differentiates
``forward_train`` with autograd and updates the model in place, on every
rank.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import shard_map as sm
from repro_torch.models import attention as attn_mod
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import KVCache
from repro_torch.models.mla import MLACache
from repro_torch.models.rglru import RglruState
from repro_torch.models.rwkv6 import RwkvState
from repro_torch.sharding import rules as shrules
from repro_torch.train import optimizer as opt_mod

# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------


def model_shardings(cfg: ArchConfig, mesh, rules: Optional[dict] = None):
    """({name: shape}, {name: DTensor placements}); nothing is drawn."""
    shapes = tfm.param_shapes(cfg)
    return shapes, shrules.param_shardings(shapes, tfm.param_axes(cfg),
                                           mesh, rules)


def opt_shardings(param_shardings: dict, mesh):
    """The optimizer state's placements: the step replicated, the moments
    as their parameters."""
    rep = shrules.placements_for((), mesh)
    return opt_mod.OptState(rep, dict(param_shardings),
                            dict(param_shardings))


def dp_axes_for(batch: int, mesh):
    """(pod, data) axes when the global batch divides them; else None."""
    axes = tuple(a for a in ("pod", "data") if a in shrules.axis_names(mesh))
    if not axes:
        return None
    shape = shrules.mesh_shape(mesh)
    size = 1
    for a in axes:
        size *= shape[a]
    if batch % size == 0:
        return axes
    if "data" in shape and batch % shape["data"] == 0:
        return ("data",)
    return None


def batch_shardings(cfg: ArchConfig, mesh, kind: str, batch: int,
                    act_rules: Optional[dict] = None) -> dict:
    """{input name: spec} of a step's batch."""
    if act_rules is not None and act_rules.get("batch") is not None:
        shape = shrules.mesh_shape(mesh)
        want = act_rules["batch"]
        want = want if isinstance(want, tuple) else (want,)
        axes = tuple(a for a in want if a in shape)
        size = 1
        for a in axes:
            size *= shape[a]
        dp = axes if (axes and (batch == 0 or batch % size == 0)) \
            else dp_axes_for(batch, mesh)
    else:
        dp = dp_axes_for(batch, mesh)
    dp = shrules.entry(dp)
    out = {}
    if kind != "decode" and cfg.input_mode == "embeddings":
        out["embeds"] = (dp, None, None)
        if cfg.rope == "mrope":
            out["mrope_positions"] = (None, dp, None)
    else:
        out["tokens"] = (dp, None)
    if kind == "train":
        out["labels"] = (dp, None)
    return out


def cache_shardings(caches: list, mesh,
                    act_rules: Optional[dict] = None) -> list:
    """The layout of each layer's decode cache (whole-batch caches, as
    ``transformer.init_cache`` makes them; the specs of its leaves,
    without the reference's stacked layers axis), as the port's steps
    place them under ``act_rules`` (``rules.activation_rules(mesh)`` by
    default): the batch over the axes the decode step splits it on; the
    KV heads over ``"model"`` where they divide, else the slots where
    they divide (``attention.cache_split``); a latent cache (``MLACache``)
    whole but for the batch; the RWKV heads
    (``heads``) and the RG-LRU width (``ff``) over ``"model"`` where the
    rules split them. Under the reference's ``ACT_RULES`` this is the
    reference's ``cache_shardings``; ``local_shape`` gives a rank's
    leaves."""
    rules = act_rules or shrules.activation_rules(mesh)

    def on_model(axis, size, split):
        return "model" if common.model_split(
            axis, size, rules=rules, mesh=mesh, split=split) else None

    def leaf(node):
        split = batch_axes(None, mesh, "decode", node[0].shape[0], rules)
        dp = shrules.entry(split)
        if isinstance(node, KVCache):
            _, size, hkv, _ = node.k.shape
            how = attn_mod.cache_split(hkv, size, rules=rules, mesh=mesh,
                                       split=split)
            spec = (dp, "model" if how == "seq" else None,
                    "model" if how == "kv" else None, None)
            return KVCache(spec, spec, ())
        if isinstance(node, MLACache):
            return MLACache((dp, None, None), (dp, None, None), ())
        if isinstance(node, RwkvState):
            hs = on_model("heads", node.wkv.shape[1], split)
            return RwkvState((dp, hs, None, None), (dp, None), (dp, None))
        if isinstance(node, RglruState):
            ws = on_model("ff", node.h.shape[-1], split)
            return RglruState((dp, ws), (dp, None, ws))
        raise TypeError(type(node))

    return [leaf(c) for c in caches]


def local_shape(shape, spec, mesh) -> tuple:
    """A rank's shape of a tensor of ``shape`` laid out as ``spec``."""
    out = []
    for n, entry in zip(shape, spec):
        for a in () if entry is None else \
                entry if isinstance(entry, tuple) else (entry,):
            n //= sm.axis_size(mesh, a)
        out.append(n)
    return tuple(out)


def _split_microbatches(batch: dict, micro: int) -> list[dict]:
    """``micro`` consecutive slices of the batch (axis 1 of
    ``mrope_positions``, axis 0 of the rest), as the reference's reshape
    splits it."""
    def split(key, leaf, i):
        axis = 1 if key == "mrope_positions" else 0
        b = leaf.shape[axis]
        if b % micro:
            raise ValueError(f"{key}: batch {b} is not a multiple of "
                             f"{micro} microbatches")
        return leaf.narrow(axis, i * (b // micro), b // micro)
    return [{k: split(k, v, i) for k, v in batch.items()}
            for i in range(micro)]


def _batch_size(batch: dict) -> int:
    key = next(k for k in batch if k != "mrope_positions")
    return batch[key].shape[0]


def batch_axes(cfg: ArchConfig, mesh, kind: str, batch: int,
               act_rules: Optional[dict] = None) -> tuple:
    """The mesh axes a step's batch of ``batch`` rows is split over, in
    its layout's order: the batch entry of ``batch_shardings`` (the
    ``act_rules`` batch axes where they divide it, else ``dp_axes_for``);
    ``()`` where the batch is kept whole."""
    spec = batch_shardings(cfg, mesh, kind, batch, act_rules)
    entry = spec["embeds" if "embeds" in spec else "tokens"][0]
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_rows(batch: dict, mesh, axes: tuple) -> dict:
    """The rank's rows of a global batch split over ``axes`` (as
    ``batch_axes`` gives them, the first axis outermost: pod-major; axis 1
    of ``mrope_positions``); the whole batch where ``axes`` is empty."""
    if not axes:
        return batch
    n, i = 1, 0
    for a in axes:
        size = sm.axis_size(mesh, a)
        n *= size
        i = i * size + sm.axis_index(mesh, a)
    b = _batch_size(batch)
    if b % n:
        raise ValueError(f"batch {b} does not split over the {n} ranks "
                         f"of {axes}")
    return {k: v.narrow(1 if k == "mrope_positions" else 0,
                        i * (b // n), b // n)
            for k, v in batch.items()}


@contextlib.contextmanager
def _activation_rules(rules, mesh, batch: int, axes: tuple):
    """The activation rules and the batch's split installed for one step
    call: the model's constraints, losses and gradient reductions read
    them."""
    common.set_activation_rules(rules, mesh, batch, axes)
    try:
        yield
    finally:
        common.clear_activation_rules()


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, opt_cfg: opt_mod.AdamWConfig,
                    impl: str = "reference", *, mesh=None,
                    rules: Optional[dict] = None,
                    act_rules: Optional[dict] = None,
                    global_batch: int = 0):
    """``train_step(model, opt_state, batch) -> (opt_state, metrics)``:
    forward and backward over ``cfg.microbatches`` microbatches, then the
    AdamW update of ``model``'s parameters in place. With microbatches
    the gradients are summed in float32 and divided by their count; with
    one they stay in the parameters' dtype, as the reference types them.
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` (device
    scalars). The kernel routes have no backward pass (nor have the
    reference's Pallas kernels), so ``impl`` is ``"reference"`` or
    ``"blocked"``.

    With ``mesh`` every rank passes the whole global batch: each
    microbatch (consecutive rows, as the reference's reshape splits them)
    is cut to the rank's rows over the axes ``batch_axes`` gives for the
    microbatch's rows (gradients and the loss are summed over those axes
    and averaged over the batch axes the rows are kept whole on), and
    ``metrics`` are the global ones on every rank. ``rules``
    (``PARAM_RULES`` by default) is checked against the model's layout at
    the first call, ``act_rules`` places the activations
    (``rules.activation_rules(mesh)`` by default); ``global_batch``, when
    given, is checked against the batch."""
    if impl not in ("reference", "blocked"):
        raise ValueError(f"impl {impl!r} runs forward-only kernels; train "
                         "with 'reference' or 'blocked'")
    micro = cfg.microbatches
    checked = []
    if mesh is not None:
        act_rules = act_rules or shrules.activation_rules(mesh)

    def check_layout(model):
        _, placements = model_shardings(cfg, mesh, rules)
        for name, p in model.named_parameters():
            if list(p.placements) != placements[name]:
                raise ValueError(f"{name} is laid out as {p.placements}, "
                                 f"the rules give {placements[name]}")
        checked.append(True)

    def loss_and_grads(model, params, mb):
        loss, _ = tfm.forward_train(model, cfg, mb, impl=impl, mesh=mesh)
        # A parameter the loss does not reach gets zeros, as under jax.grad.
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), [sm.to_local(g) for g in grads]

    def run(model, names, params, batch, axes):
        mbs = _split_microbatches(batch, micro) if micro > 1 else [batch]
        acc, loss_sum = None, 0.0
        for mb in mbs:
            if mesh is not None:
                mb = local_rows(mb, mesh, axes)
            loss, grads = loss_and_grads(model, params, mb)
            if micro == 1:
                return loss, grads
            if acc is None:
                acc = [g.float() for g in grads]
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)
            del grads
            loss_sum = loss_sum + loss
        return loss_sum / micro, [a.div_(micro) for a in acc]

    def train_step(model, opt_state, batch: dict):
        if global_batch and _batch_size(batch) != global_batch:
            raise ValueError(f"step built for batch {global_batch}, got "
                             f"{_batch_size(batch)}")
        names, params = zip(*model.named_parameters())
        for p in params:
            p.requires_grad_(True)
        if mesh is not None and not checked:
            check_layout(model)
        if mesh is None:
            loss, grads = run(model, names, params, batch, ())
        else:
            rows = _batch_size(batch) // micro
            axes = batch_axes(cfg, mesh, "train", rows, act_rules)
            with _activation_rules(act_rules, mesh, rows, axes):
                loss, grads = run(model, names, params, batch, axes)
            grads = [sm.make_dtensor(g, sm.spec_of(p), mesh, p.shape)
                     for g, p in zip(grads, params)]
        _, opt_state, metrics = opt_mod.apply_updates(
            model, dict(zip(names, grads)), opt_state, opt_cfg)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ArchConfig, cache_len: int,
                      impl: str = "reference", *, mesh=None,
                      act_rules: Optional[dict] = None):
    """``prefill_step(model, batch) -> (last logits (B, V), caches)``;
    under ``mesh`` the rank's rows of both, from the global batch."""
    if mesh is not None:
        act_rules = act_rules or shrules.activation_rules(mesh)

    def prefill_step(model, batch: dict):
        with torch.inference_mode():
            if mesh is None:
                return tfm.forward_prefill(model, cfg, batch, cache_len,
                                           impl=impl)
            rows = _batch_size(batch)
            axes = batch_axes(cfg, mesh, "prefill", rows, act_rules)
            with _activation_rules(act_rules, mesh, rows, axes):
                return tfm.forward_prefill(model, cfg,
                                           local_rows(batch, mesh, axes),
                                           cache_len, impl=impl, mesh=mesh)

    return prefill_step


def make_decode_step(cfg: ArchConfig, batch_size: int, *, mesh=None,
                     act_rules: Optional[dict] = None):
    """``decode_step(model, tokens (B, 1), caches, position) -> (logits,
    caches)``; the attention caches are updated in place. Under ``mesh``
    the tokens are the global batch's, the caches and the logits the
    rank's rows, split over the axes in ``decode_step.batch_axes``
    (``()`` without a mesh), the caches laid out as ``cache_shardings``
    gives under ``act_rules`` (``rules.activation_rules(mesh)`` by
    default; the prefill step must run the same rules)."""
    axes = ()
    if mesh is not None:
        act_rules = act_rules or shrules.activation_rules(mesh)
        axes = batch_axes(cfg, mesh, "decode", batch_size, act_rules)

    def decode_step(model, tokens, caches, position: int):
        if tokens.shape[0] != batch_size:
            raise ValueError(f"decode step built for batch {batch_size}, "
                             f"got {tokens.shape[0]}")
        with torch.inference_mode():
            if mesh is None:
                return tfm.forward_decode(model, cfg, tokens, caches,
                                          position)
            with _activation_rules(act_rules, mesh, batch_size, axes):
                return tfm.forward_decode(
                    model, cfg, local_rows({"tokens": tokens}, mesh, axes)[
                        "tokens"], caches, position, mesh=mesh)

    decode_step.batch_axes = axes
    return decode_step
