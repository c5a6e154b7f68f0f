"""Decoder-only transformer stack, dense and MoE (PyTorch).

Layer-stacked parameters (a leading ``layers`` axis, as in the
reference) applied by an unrolled Python loop: crossbar tiles are
addressed by layer NAME, which the crossbar backend needs anyway.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core import executor as xbar
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnConfig, MoEConfig

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    attn: AttnConfig
    d_ff: int
    act: str = "swiglu"
    moe: Optional[MoEConfig] = None


def block_init(gen, cfg: BlockConfig, device) -> Params:
    d = cfg.attn.d_model
    p = {"ln1": torch.ones((d,), device=device),
         "attn": L.attn_init(gen, cfg.attn, device),
         "ln2": torch.ones((d,), device=device)}
    if cfg.moe is not None:
        p["moe"] = L.moe_init(gen, d, cfg.d_ff, cfg.moe, device)
    else:
        p["mlp"] = L.mlp_init(gen, d, cfg.d_ff, cfg.act, device)
    return p


def block(p, cfg: BlockConfig, x, positions, cache=None):
    """Pre-norm residual block.  Returns (x, new_cache)."""
    with xbar.scope("attn"):
        h, new_cache = L.attention(p["attn"], cfg.attn,
                                   L.rmsnorm(x, p["ln1"]), positions,
                                   cache=cache)
    x = x + h
    if cfg.moe is not None:
        # plain products, outside any scope: no expert is programmed
        h, _ = L.moe_block(p["moe"], L.rmsnorm(x, p["ln2"]), cfg.moe)
    else:
        with xbar.scope("mlp"):
            h = L.mlp(p["mlp"], L.rmsnorm(x, p["ln2"]), cfg.act)
    return x + h, new_cache


# -- stacked layers ------------------------------------------------------------

def stack_init(gen, cfg: BlockConfig, n_layers: int, device) -> Params:
    """n_layers blocks with stacked (leading 'layers' axis) params, drawn
    layer by layer and written straight into the stacked tensors."""
    first = block_init(gen, cfg, device)
    stacked = _tree_map(
        lambda a: torch.empty((n_layers,) + tuple(a.shape), dtype=a.dtype,
                              device=device), first)
    for layer in range(n_layers):
        p_l = first if layer == 0 else block_init(gen, cfg, device)
        _tree_zip(lambda s, a, ll=layer: s[ll].copy_(a), stacked, p_l)
        del p_l
    return stacked


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    else:
        fn(a, b)


def stack_apply(stacked_p, cfg: BlockConfig, x, positions, caches=None):
    """Apply the blocks in order (unrolled; each layer's tiles are named
    ``<scope>.<layer>.<module>.<weight>``).

    caches: stacked per-layer caches (dict of (L, ...) tensors) or None.
    Each layer updates its K/V pages and its fill marker in place through
    views of the stacked tensors; the returned caches are the same dict.
    Returns (x, caches).
    """
    n_layers = stacked_p["ln1"].shape[0]
    for layer in range(n_layers):
        p_l = _tree_map(lambda a, ll=layer: a[ll], stacked_p)
        cache_l = ({k: c[layer] for k, c in caches.items()}
                   if caches is not None else None)
        with xbar.scope(layer):   # names this layer's resident tiles
            x, _ = block(p_l, cfg, x, positions, cache=cache_l)
    return x, caches


# -- embeddings / head ----------------------------------------------------------

def embed_init(gen, vocab: int, d_model: int, device) -> Params:
    return {"tok": L.normal(gen, (vocab, d_model), 0.02, device)}


def embed(p, tokens):
    return p["tok"][tokens.to(torch.int64)]


def unembed(p, x, head=None):
    w = head if head is not None else p["tok"].T
    return torch.einsum("bsd,dv->bsv", x, w.to(x.dtype))
