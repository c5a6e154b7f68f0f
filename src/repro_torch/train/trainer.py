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

On a CUDA device the donated step is captured: ``make_train_step``
returns a ``GraphTrainStep``, the reference's ``jax.jit(train_step,
donate_argnums=(0,))`` as one CUDA graph over static buffers (the state
it is first called with, a batch buffer, the metrics), warmed up
eagerly, captured at its second call and replayed after that.

``state_specs`` is the state's logical layout (the params' specs for
the masters and both moments); under installed sharding rules the
compute copy is pinned to its master's placements.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed import sharding as shd
from repro_torch.graphs import GraphStep, resolve_capture
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
                    unroll_accum: bool = False, donate: bool = False,
                    capture: Optional[bool] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``donate=True`` is the reference CLIs' ``donate_argnums=(0,)``:
    the step writes the new state into the old one's tensors
    (``optimizer.update(..., donate=True)``), so the old state must not
    be read again; the default writes nothing in place.

    ``capture`` (``None``: on a CUDA model) makes the donated step a
    ``GraphTrainStep``, replayed from one CUDA graph; ``False`` returns
    the eager step, the witness; ``True`` on a model that is not on CUDA
    raises.  A graph replays into fixed buffers, so capture needs
    ``donate=True``: on a CUDA model the undonated step raises unless
    ``capture=False`` is passed.

    ``grad_accum_dtype=torch.bfloat16`` halves the microbatch gradient
    accumulator: each microbatch's gradient is added in float32 and the
    sum rounded once to it, as the reference.  The accumulated gradient
    is divided by ``microbatches`` in float32.  ``unroll_accum`` is the
    reference's cost-probe switch between a rolled and an unrolled loop;
    here the loop is always a Python loop (unrolled in a captured
    graph), so it changes nothing.
    """
    del unroll_accum
    if not donate and (capture or (capture is None
                                   and model.device.type == "cuda")):
        raise ValueError(
            "a captured train step needs donate=True (a CUDA graph "
            "replays into the state's own tensors); pass capture=False "
            "for the undonated step")
    capture = resolve_capture(capture, model.device)

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

    if capture:
        return GraphTrainStep(train_step, model.device, capture=True)
    return train_step


class GraphTrainStep(GraphStep):
    """A donated train step ``step_fn(state, batch) -> (state, metrics)``
    over static buffers, run as ``step(state, batch)``: with ``capture``
    replayed from one CUDA graph (``graphs.GraphStep``: the first call
    the eager warm-up, on a side stream; the second captured, the cache
    emptied first; every later call a replay), without it the same body
    run eagerly each call.

    The first call binds ``state`` as the static state: the float32
    masters, ``m``, ``v`` and ``step``, each written in place by every
    call.  A later call must pass a state whose leaves are that storage
    (the state a call returned); any other state raises, so a restored
    or fresh state needs a new step.  The batch is copied into a static
    buffer made at the first call (a later batch of other keys, shapes
    or dtypes raises).  A call returns the bound state object and the
    static metrics, which the next call overwrites: read them before it.
    :meth:`reset` releases the graph.
    """

    def __init__(self, step_fn: Callable, device, capture: bool):
        super().__init__(capture)
        self._fn, self.device = step_fn, torch.device(device)
        self.state: Optional[TrainState] = None
        self.batch: Optional[Dict[str, torch.Tensor]] = None
        self.metrics: Optional[Dict[str, torch.Tensor]] = None
        self._leaves: Tuple[torch.Tensor, ...] = ()

    def __call__(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if self.state is None:
            self.state, self._leaves = state, tuple(tree.leaves(state))
            self.batch = {k: torch.empty(v.shape, dtype=v.dtype,
                                         device=self.device)
                          for k, v in batch.items()}
        else:
            self._check_state(state)
        self._load(batch)
        self.run()
        return self.state, self.metrics

    def _check_state(self, state) -> None:
        leaves = tree.leaves(state)
        if len(leaves) != len(self._leaves) or any(
                a is not b and (a.data_ptr() != b.data_ptr()
                                or a.shape != b.shape or a.dtype != b.dtype)
                for a, b in zip(leaves, self._leaves)):
            raise ValueError(
                "this train step's static state is the state of its first "
                "call, and the state given is not its storage (a restored "
                "or fresh state?); build a new step for it")

    def _load(self, batch) -> None:
        if set(batch) != set(self.batch) or any(
                v.shape != self.batch[k].shape
                or v.dtype != self.batch[k].dtype for k, v in batch.items()):
            raise ValueError(
                f"batch {_shapes(batch)} does not fit the static batch "
                f"{_shapes(self.batch)}")
        for k, v in batch.items():
            self.batch[k].copy_(v)

    def body(self) -> None:
        state, metrics = self._fn(self.state, self.batch)
        if any(a is not b for a, b in zip(tree.leaves(state),
                                          self._leaves)):
            raise RuntimeError("the donated step returned a state leaf in "
                               "new storage")
        if self.metrics is None:
            self.metrics = {k: v.detach().clone()
                            for k, v in metrics.items()}
        else:
            for k, v in metrics.items():
                self.metrics[k].copy_(v)

    def scope(self):
        """The warm-up runs on a side stream, as PyTorch's recipe for
        capturing a whole training step asks."""
        if self.capture and not self._warm:
            return _side_stream()
        return contextlib.nullcontext()

    def _capture(self) -> None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()      # the warm-up's blocks, not the pool's
        super()._capture()


@contextlib.contextmanager
def _side_stream():
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        yield
    torch.cuda.current_stream().wait_stream(side)


def _shapes(batch) -> Dict[str, Tuple]:
    return {k: (str(v.dtype), tuple(v.shape)) for k, v in batch.items()}


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
