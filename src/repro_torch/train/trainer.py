"""The train step (PyTorch): mixed precision over float32 masters and
microbatch accumulation, as the reference's.

``make_train_step(model, opt_cfg, microbatches=1)`` returns
``train_step(state, batch) -> (state, metrics)``.  ``TrainState`` is
(params: the float32 masters, opt: AdamW ``m``/``v``/``step``).  The
forward pass runs on a copy of the params in which every float32 leaf of
rank >= 2 is cast to the compute dtype (bfloat16 by default); the
gradient is taken with respect to that copy, as the reference
differentiates through its cast.  The step builds new tensors and writes
none of the state's in place unless asked to (``donate``).

``state_specs`` is the state's logical layout (the params' specs for
the masters and both moments); under installed sharding rules the
compute copy is pinned to its master's placements.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import Model
from repro_torch.train import optimizer as opt


class TrainState(NamedTuple):
    params: Any
    opt: opt.OptState


def init_state(model: Model, seed: int = 0,
               opt_state_dtype=torch.float32) -> TrainState:
    """Fresh params from ``seed`` on the model's device (CUDA unless the
    model was built for the CPU), as float32 masters, and zero moments."""
    params = tree.map(lambda p: p.to(torch.float32), model.init(seed))
    return TrainState(params=params, opt=opt.init(params, opt_state_dtype))


def state_specs(model: Model) -> TrainState:
    """The logical axes of a ``TrainState``: ``m`` and ``v`` shard
    exactly like their params; ``step`` is a scalar."""
    ps = model.param_specs()
    return TrainState(params=ps, opt=opt.OptState(m=ps, v=ps, step=()))


def _split_microbatch(batch, n: int, i: int):
    def sl(x):
        if isinstance(x, shd.DTensor) and any(
                p.is_shard(0) for p in x.placements):
            return _split_rows(x, n, i)
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per]

    return {k: sl(v) for k, v in batch.items()}


def _split_rows(x, n: int, i: int):
    """Microbatch ``i`` of ``n`` of a batch split over ranks on its rows:
    each rank's own i-th share of its rows (a slice of the split dim
    itself would gather the batch whole on every rank).  The microbatch
    takes rows from every rank, so its rows are not the reference's
    contiguous ones; the accumulated step sums the same rows."""
    local = x.to_local()
    per = local.shape[0] // n
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    return shd.DTensor.from_local(
        local[i * per:(i + 1) * per], x.device_mesh, x.placements,
        run_check=False, shape=torch.Size(shape),
        stride=shd.contiguous_stride(shape))


def make_train_step(model: Model, opt_cfg: opt.AdamWConfig,
                    microbatches: int = 1, compute_dtype=torch.bfloat16,
                    grad_accum_dtype=torch.float32,
                    unroll_accum: bool = False, donate: bool = False):
    """Returns train_step(state, batch) -> (state, metrics).

    ``donate=True`` is the reference CLIs' ``donate_argnums=(0,)``:
    the step writes the new state into the old one's tensors
    (``optimizer.update(..., donate=True)``), so the old state must not
    be read again; the default writes nothing in place.

    ``grad_accum_dtype=torch.bfloat16`` halves the microbatch gradient
    accumulator: each microbatch's gradient is added in float32 and the
    sum rounded once to it, as the reference.  The accumulated gradient
    is divided by ``microbatches`` in float32.  ``unroll_accum`` is the
    reference's cost-probe switch between a rolled and an unrolled loop;
    here the loop is always a Python loop, so it changes nothing.
    """
    del unroll_accum

    def cast(params):
        c = tree.map(
            lambda x: (x.detach().to(compute_dtype)
                       if x.dtype == torch.float32 and x.dim() >= 2
                       else x.detach()), params)
        # pin the cast copy to its float32 master's placements, so the
        # cast happens shard-local and the per-layer gathers move bf16
        # (a DTensor cast keeps its placements already; the constraint
        # holds the layout wherever the rules say otherwise)
        rules = shd.current_rules()
        if rules is not None:
            c = shd.map_specs(
                lambda names, x, m: _pin(x, m), model.param_specs(), c,
                params)
        return tree.map(lambda x: x.requires_grad_(), c)

    def value_and_grad(params_c, batch):
        leaves = tree.leaves(params_c)
        with torch.enable_grad():
            loss, metrics = model.loss_fn(params_c, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), metrics, grads

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params_c = cast(state.params)
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(params_c, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            leaves = tree.leaves(params_c)
            gacc = [torch.zeros_like(p, dtype=grad_accum_dtype)
                    for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(microbatches):
                mb = _split_microbatch(batch, microbatches, i)
                lval, _, g = value_and_grad(params_c, mb)
                for j in range(len(gacc)):   # one leaf's copy at a time
                    gacc[j] = (gacc[j].to(torch.float32)
                               + g[j].to(torch.float32)
                               ).to(grad_accum_dtype)
                    g[j] = None
                loss = loss + lval
            div = torch.full((), microbatches, dtype=torch.float32,
                             device=loss.device)
            grads = []
            for j in range(len(gacc)):
                grads.append(torch.div(gacc[j].to(torch.float32), div))
                gacc[j] = None
            loss = torch.div(loss, div)
            metrics = {"loss": loss}
        grads = tree.unflatten(params_c, grads)
        del params_c
        new_params, new_opt, stats = opt.update(opt_cfg, state.params,
                                                grads, state.opt,
                                                donate=donate)
        return TrainState(new_params, new_opt), dict(metrics, **stats)

    return train_step


def _pin(x, master):
    """``x`` on ``master``'s placements (a DTensor master), else as is."""
    if isinstance(master, shd.DTensor) and isinstance(x, shd.DTensor) and (
            tuple(x.placements) != tuple(master.placements)):
        return x.redistribute(master.device_mesh, master.placements)
    return x


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = model.loss_fn(params, batch)
        return metrics

    return eval_step
