"""The training step: loss -> grad -> AdamW, with microbatched gradient
accumulation, the model's remat policy, and optional int8 error-feedback
gradient compression.

PyTorch counterpart of ``repro.training.train_step`` on one device.  The
train state is ``{"params", "opt"[, "err"]}``: ``params`` the model's own
parameters by name, ``opt`` the optimizer's state, ``err`` the
compression's error buffers in the reference's tree (the reference
quantizes each leaf of its tree, so one scale covers a weight's stacked
layers).  ``make_train_step`` returns
``step(state, batch) -> (state, metrics)``; the step updates the model's
parameters and the optimizer's tensors in place, as the reference's jitted
step does with donated buffers.  ``state_tree`` lays a state out as the
reference's tree (stacked ``[L, ...]`` leaves), which is what checkpoints
hold.

A model under a mesh (``Model.policy``) trains on DTensor parameters and
optimizer state; the grad norm and clipping are over the whole tensors,
as under GSPMD, and the metrics come back as plain tensors (the same on
every rank).  Its ``err`` is one fp32 DTensor per parameter, on the
gradient's placements; each reference leaf still has one scale over all
its layers (``compression.quantize_layers``).  ``state_tree`` gathers a
sharded state whole, ``err`` stacked into the reference's tree too;
``train_state_placements`` gives the placements a checkpoint's tree is
restored onto (``checkpoint.restore(placements=...)``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.models.convert import (from_jax_params, leaf_groups,
                                        to_jax_params)
from repro_torch.models.model import Model
from repro_torch.sharding.policy import is_dtensor, whole
from repro_torch.training import compression as comp
from repro_torch.training import optimizer as opt

TrainState = Dict[str, Any]


def _placed_as(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient on its parameter's placements: a pending sum (a
    replicated weight's gradient over sharded activations) is reduced
    here, before the optimizer squares it."""
    if is_dtensor(g) and tuple(g.placements) != tuple(w.placements):
        return g.redistribute(w.device_mesh, w.placements)
    return g


def train_state_specs(model: Model) -> Dict:
    """The reference's ``train_state_specs``: the params' specs
    (``Model.param_specs``, per layer) and the optimizer's."""
    pspecs = model.param_specs()
    return {"params": pspecs, "opt": opt.state_specs(pspecs)}


def train_state_shapes(model: Model, cfg: opt.AdamWConfig) -> Dict:
    """The reference's ``train_state_shapes``: the train state's tree
    (``state_tree``'s layout) as ``meta`` tensors, allocating nothing."""
    meta = Model(model.arch, device="meta", dtype=model.dtype)
    return state_tree(meta, init_train_state(meta, None, cfg), device="meta")


def _stacked_specs(model: Model) -> Dict:
    """``Model.param_specs`` laid over ``to_jax_params``' tree: a stacked
    leaf's spec gains a leading (replicated) layer dim, two for an MoE
    model's dense layers ``[n_groups, moe_every - 1, ...]``."""
    specs = model.param_specs()

    def lead(table, n):
        return {k: (None,) * n + tuple(v) for k, v in table.items()}

    out = {k: specs[k] for k in ("embed", "final_norm", "lm_head")
           if k in specs}
    if model.arch.family == "moe":
        out["blocks"] = {k: lead(v, 1 if k == "moe" else 2)
                         for k, v in specs["blocks"].items()}
    else:
        out["blocks"] = lead(specs["blocks"], 1)
    if "shared_attn" in specs:
        out["shared_attn"] = lead(specs["shared_attn"], 1)
    return out


def train_state_placements(model: Model, state: TrainState) -> Dict:
    """``(mesh, placements)`` per leaf of ``state_tree(model, state)`` (None
    where a leaf stays a plain tensor: the step), for
    ``checkpoint.restore(placements=...)``; the error buffers are placed as
    the parameters are.  All None without a mesh."""
    pol = model.policy

    def place(spec):
        if isinstance(spec, dict):
            return {k: place(v) for k, v in spec.items()}
        return None if pol.mesh is None else (pol.mesh,
                                               pol.placements_of(spec))

    params = place(_stacked_specs(model))
    out = {"params": params, "opt": {"master": params, "m": params,
                                     "v": params, "step": None}}
    if "err" in state:
        out["err"] = (params if pol.mesh is not None else
                      comp.map_tree(lambda t: None, state["err"]))
    return out


def init_train_state(model: Model, generator: Optional[torch.Generator],
                     cfg: opt.AdamWConfig) -> TrainState:
    """Make ``model``'s parameters trainable (random weights from
    ``generator``, or the weights it holds when None; placed on the
    policy's mesh, if any) and the optimizer's state for them."""
    if generator is not None:
        model.init(generator)
    model.distribute()
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return {"params": params, "opt": opt.init_state(params)}


def batch_on(batch: Mapping[str, Any], device: torch.device
             ) -> Dict[str, torch.Tensor]:
    """A batch of ``training.data`` (numpy, or tensors) as tensors on
    ``device`` (token ids and labels as int64)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def make_train_step(model: Model, cfg: opt.AdamWConfig, *,
                    microbatches: int = 1,
                    grad_compression: Optional[str] = None):
    """Returns step(state, batch) -> (state, metrics).

    ``microbatches`` > 1 slices the batch and accumulates the grads in
    fp32, averaging loss and grads over the slices.
    ``grad_compression='int8'`` quantizes the accumulated gradient with
    error feedback before the optimizer (the state grows an ``err``
    buffer).  ``batch`` is numpy arrays or tensors (moved to the model's
    device).  Metrics (``loss``, ``grad_norm``, ``lr``) are 0-d tensors on
    the device; nothing is read back to the host."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression {grad_compression!r}")
    named = list(model.named_parameters())
    names = [n for n, _ in named]
    weights = [p for _, p in named]
    leaves = (leaf_groups(model.arch, names)
              if grad_compression == "int8" and model.sharded else [])

    def _compress_layers(grads, err):
        """int8 error feedback on a mesh: each reference leaf's layers
        quantized against one scale (``comp.quantize_layers``), ``err``
        per parameter on its gradient's placements.  The gradients come
        back in the order ``from_jax_params`` gives the unsharded path's,
        the order the grad norm sums them in."""
        if err is None:
            err = {n: torch.zeros_like(g, dtype=torch.float32)
                   for n, g in grads.items()}
        out, new = {}, {}
        for group in leaves:
            deq, fresh = comp.quantize_layers([grads[n] for n in group],
                                              [err[n] for n in group])
            out.update(zip(group, deq))
            new.update(zip(group, fresh))
        return out, new

    def value_and_grad(batch):
        loss = model.loss(batch)
        with model.on_mesh():   # the backward meets the plain tensors too
            grads = torch.autograd.grad(loss, weights, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), {n: _placed_as(g, w)
                               for n, g, w in zip(names, grads, weights)}

    def grads_of(batch):
        if microbatches <= 1:
            return value_and_grad(batch)
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{microbatches} microbatches")
        mb = B // microbatches
        loss_acc = torch.zeros((), dtype=torch.float32, device=model.device)
        g_acc = {n: opt._zeros32(p) for n, p in named}
        for i in range(microbatches):
            loss, g = value_and_grad({k: v[i * mb:(i + 1) * mb]
                                      for k, v in batch.items()})
            for n in names:
                g_acc[n].add_(g[n])
            loss_acc = loss_acc + loss
        inv = 1.0 / microbatches
        return loss_acc * inv, {n: g * inv for n, g in g_acc.items()}

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        with torch.no_grad():
            for n, p in named:
                if state["params"][n] is not p:
                    p.copy_(state["params"][n])
        loss, grads = grads_of(batch_on(batch, model.device))
        if grad_compression == "int8" and model.sharded:
            grads, err = _compress_layers(grads, state.get("err"))
        elif grad_compression == "int8":
            tree = to_jax_params(model.arch, grads)
            err = state.get("err")
            if err is None:
                err = comp.init_error_buffers(tree)
            tree, err = comp.compressed_psum(tree, err, group=None)
            grads = from_jax_params(model.arch, tree)
        gnorm = opt.global_norm(grads)
        params, opt_state = opt.apply_updates(
            cfg, state["opt"], grads, param_dtype=model.dtype)
        del grads
        with torch.no_grad():
            for n, p in named:
                p.copy_(params.pop(n))
        new_state = {"params": dict(named), "opt": opt_state}
        if grad_compression == "int8":
            new_state["err"] = err
        metrics = {"loss": whole(loss), "grad_norm": whole(gnorm),
                   "lr": opt.schedule(cfg, opt_state["step"])}
        return new_state, metrics

    return step


@torch.no_grad()
def state_tree(model: Model, state: TrainState,
               device: Union[str, torch.device, None] = None) -> Dict:
    """``state`` as the reference's train-state tree: params and each
    optimizer tree through ``convert.to_jax_params`` (stacked on
    ``device``; ``"meta"`` gives the shapes alone), ``step`` as it is.  A
    DTensor is gathered whole (a collective: every rank calls this)."""
    arch = model.arch

    def gathered(t):
        if is_dtensor(t) and device is not None and \
                torch.device(device).type == "meta":
            return torch.empty(t.shape, dtype=t.dtype, device="meta")
        return whole(t)

    def tree(d):
        return to_jax_params(arch, {k: gathered(t) for k, t in d.items()},
                             device)

    o = state["opt"]
    out = {"params": tree(state["params"]),
           "opt": {"master": tree(o["master"]), "m": tree(o["m"]),
                   "v": tree(o["v"]),
                   "step": o["step"] if device is None
                   else o["step"].to(device)}}
    if "err" in state and model.sharded:
        out["err"] = tree(state["err"])
    elif "err" in state:
        out["err"] = (state["err"] if device is None else
                      comp.map_tree(lambda t: t.to(device), state["err"]))
    return out


@torch.no_grad()
def load_state_tree(model: Model, state: TrainState, tree: Dict
                    ) -> TrainState:
    """Copy a reference-shaped tree (``state_tree``'s layout, e.g. from
    ``checkpoint.restore``) into ``state`` in place; the tree's ``err``
    buffers, if any, become the state's, on the model's device.  Returns
    the state.  Into a DTensor state a plain leaf is distributed (each
    rank holds the whole value) and a DTensor one (restored with
    placements) is copied shard to shard."""
    arch = model.arch

    def copy(dst, src):
        for k, t in from_jax_params(arch, src).items():
            if is_dtensor(dst[k]) and not is_dtensor(t):
                from torch.distributed.tensor import distribute_tensor
                t = distribute_tensor(t.to(dst[k].device), dst[k].device_mesh,
                                      dst[k].placements, src_data_rank=None)
            dst[k].copy_(t)

    copy(state["params"], tree["params"])
    for k in ("master", "m", "v"):
        copy(state["opt"][k], tree["opt"][k])
    state["opt"]["step"].copy_(torch.as_tensor(tree["opt"]["step"]))
    if "err" in tree and model.sharded:
        params = state["params"]
        state["err"] = {k: torch.zeros_like(params[k], dtype=torch.float32)
                        for k in params}
        copy(state["err"], tree["err"])
    elif "err" in tree:
        state["err"] = comp.map_tree(
            lambda t: t.to(model.device, torch.float32, copy=True),
            tree["err"])
    return state
