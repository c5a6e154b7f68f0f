"""AdamW in plain PyTorch, with the reference's state layout and its
int8 gradient quantizer.

The optimizer state mirrors the parameter tree (``m`` and ``v`` are
trees of the params' shapes, ``step`` a 0-d int32), as in the
reference; no ``torch.optim``, so that the update is the reference's
arithmetic op for op: every step rounds to float32 as ``jnp`` does, and
the leaves are walked in ``jax.tree``'s order (dict keys sorted), so
``global_norm`` adds the leaves in the reference's order.

``compressed_psum`` is the error-feedback int8 all-reduce over a
process group (``torch.distributed``), the reference's over a mesh axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


# -- schedule -----------------------------------------------------------------

def _f32(v, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA computes it.
    CUDA's ``torch.sqrt`` is correctly rounded; the CPU's (SLEEF) is not
    always, so there it goes through float64, whose root rounds once more
    to the same float32 (53 >= 2 x 24 + 2 bits)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32 as the reference rounds
    it (``step`` an int32 tensor).  The cosine is float64's rounded to
    float32 (torch's float32 ``cos`` misses the correctly rounded value
    more often than XLA's)."""
    dev = step.device
    s = step.to(torch.float32)
    warm = torch.clamp(torch.div(s, _f32(max(cfg.warmup_steps, 1), dev)),
                       max=1.0)
    t = torch.clamp(torch.div(s - cfg.warmup_steps,
                              _f32(max(cfg.total_steps - cfg.warmup_steps,
                                       1), dev)), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos((_f32(math.pi, dev) * t).to(torch.float64)
                      ).to(torch.float32))
    return cfg.lr * warm * cos


def bias_corrections(cfg: AdamWConfig, step: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``1 - b1**step`` and ``1 - b2**step`` in float32, the power
    float64's of the float32 operands rounded to float32 (as XLA's)."""
    s = step.to(torch.float32).to(torch.float64)

    def power(b):
        return torch.pow(_f32(b, s.device).to(torch.float64), s).to(
            torch.float32)

    return 1 - power(cfg.b1), 1 - power(cfg.b2)


# -- state --------------------------------------------------------------------

def init(params, state_dtype=torch.float32) -> OptState:
    """Zero moments in ``state_dtype`` (bfloat16 halves the optimizer's
    memory; the update upcasts them to float32, so only their storage
    precision drops) and step 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=state_dtype)

    return OptState(m=tree.map(zeros, params), v=tree.map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=tree.leaves(params)[0].device))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares, each leaf summed in float32, the
    leaves added in ``jax.tree`` order from Python's 0."""
    return sqrt_rn(sum(torch.sum(torch.square(g.to(torch.float32)))
                       for g in tree.leaves(grads)))


def update(cfg: AdamWConfig, params, grads, state: OptState,
           donate: bool = False
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step on float32 master params.  Returns (params, state,
    stats).  ``donate=False`` builds new tensors and writes none of its
    inputs; ``donate=True`` is the reference's donated state
    (``jax.jit(..., donate_argnums=(0,))``): each new param, ``m`` and
    ``v`` is written into the old one's storage as soon as it is made,
    so one state's memory serves both, and the caller must not read the
    old state again.  The values are the same bit for bit."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        # a Python number over a tensor is a reciprocal times the number
        # in torch; the reference divides
        scale = torch.clamp(torch.div(_f32(cfg.grad_clip, gnorm.device),
                                      gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr = lr_at(cfg, step)
        b1c, b2c = bias_corrections(cfg, step)

        def upd(p, g, m, v):
            sdtype = m.dtype
            g = g.to(torch.float32) * scale
            m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
            v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * torch.square(g)
            mh = m32 / b1c
            vh = v32 / b2c
            delta = mh / (sqrt_rn(vh) + cfg.eps)
            if p.dim() >= 2:  # decoupled weight decay on matrices only
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
            if donate:
                return p.copy_(new_p), m.copy_(m32), v.copy_(v32)
            return new_p, m32.to(sdtype), v32.to(sdtype)

        out = [upd(*xs) for xs in zip(*(tree.leaves(t) for t in (
            params, grads, state.m, state.v)))]
        new_p, new_m, new_v = (tree.unflatten(params, [o[i] for o in out])
                               for i in range(3))
    return new_p, OptState(new_m, new_v, step), {"lr": lr,
                                                 "grad_norm": gnorm}


# -- int8 gradient quantization (error feedback) ------------------------------

def quantize_grad_int8(g: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 codes and their scale (``amax / 127``)."""
    amax = torch.amax(torch.abs(g)) + 1e-12
    scale = torch.div(amax, _f32(127.0, g.device))
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(g: torch.Tensor, group, err: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce: quantize (g + carried error) to
    int8 codes, all-reduce the dequantized codes over ``group`` (a
    ``torch.distributed`` process group; None for the default one), and
    carry the quantization residual to the next step.  Returns (the mean
    over the group's ranks, the new error); the error must be threaded
    through the train state, as the reference's.  Each rank passes its
    own local ``g`` and ``err`` (plain tensors)."""
    import torch.distributed as dist
    g_corr = g.to(torch.float32) + err
    q, scale = quantize_grad_int8(g_corr)
    deq_local = dequantize_grad(q, scale)
    new_err = g_corr - deq_local
    summed = deq_local.clone()
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    n = _f32(dist.get_world_size(group), summed.device)
    return torch.div(summed, n), new_err
