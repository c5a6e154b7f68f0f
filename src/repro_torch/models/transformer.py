"""Decoder-only (dense and MoE) and encoder-decoder transformer stacks
(PyTorch), the cross-entropy loss and the layer rematerialisation
policies.

Layer-stacked parameters (a leading ``layers`` axis, as in the
reference) applied by an unrolled Python loop: crossbar tiles are
addressed by layer NAME, which the crossbar backend needs anyway.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core import executor as xbar
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import logical_constraint as lc
from repro_torch.models import layers as L
from repro_torch.models.layers import AttnConfig, MoEConfig

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    attn: AttnConfig
    d_ff: int
    act: str = "swiglu"
    moe: Optional[MoEConfig] = None
    norm: str = "rms"            # "rms" | "ln"
    cross_attn: bool = False     # decoder block of an enc-dec model


def _norm_init(cfg: BlockConfig, d: int, device):
    if cfg.norm == "rms":
        return torch.ones((d,), device=device)
    return {"w": torch.ones((d,), device=device),
            "b": torch.zeros((d,), device=device)}


def _norm(cfg: BlockConfig, x, p):
    if cfg.norm == "rms":
        return L.rmsnorm(x, p)
    return L.layernorm(x, p)


def block_init(gen, cfg: BlockConfig, device) -> Params:
    d = cfg.attn.d_model
    p = {"ln1": _norm_init(cfg, d, device),
         "attn": L.attn_init(gen, cfg.attn, device),
         "ln2": _norm_init(cfg, d, device)}
    if cfg.moe is not None:
        p["moe"] = L.moe_init(gen, d, cfg.d_ff, cfg.moe, device)
    else:
        p["mlp"] = L.mlp_init(gen, d, cfg.d_ff, cfg.act, device)
    if cfg.cross_attn:
        p["ln_x"] = _norm_init(cfg, d, device)
        p["xattn"] = L.attn_init(gen, cfg.attn, device)
    return p


def block(p, cfg: BlockConfig, x, positions, cache=None, cross_kv=None,
          cross_len=None):
    """Pre-norm residual block: attention, cross-attention onto
    ``cross_kv`` (encoder-decoder blocks), then the MLP or MoE block.
    Returns (x, new_cache, aux): ``aux`` is the MoE block's load-balance
    loss (f32 zero for an MLP block).

    Megatron-SP gather points, as the reference: the attention and MLP
    inputs are constrained to "seq_act" (the sequence gathered) and the
    residual adds to "seq"; with the default rules both map to None."""
    def gather_sp(h):
        return lc(h, ("batch", "seq_act", "act_embed"))

    with xbar.scope("attn"):
        h, new_cache = L.attention(p["attn"], cfg.attn,
                                   gather_sp(_norm(cfg, x, p["ln1"])),
                                   positions, cache=cache)
    x = x + lc(h, ("batch", "seq", "act_embed"))
    if cfg.cross_attn:
        with xbar.scope("xattn"):
            h, _ = L.attention(p["xattn"], cfg.attn,
                               gather_sp(_norm(cfg, x, p["ln_x"])), None,
                               cross_kv=cross_kv, kv_len=cross_len)
        x = x + lc(h, ("batch", "seq", "act_embed"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe is not None:
        # plain products, outside any scope: no expert is programmed
        h, gates = L.moe_block(p["moe"], gather_sp(_norm(cfg, x, p["ln2"])),
                               cfg.moe)
        aux = L.moe_aux_loss(gates)
    else:
        with xbar.scope("mlp"):
            h = L.mlp(p["mlp"], gather_sp(_norm(cfg, x, p["ln2"])), cfg.act)
    return x + lc(h, ("batch", "seq", "act_embed")), new_cache, aux


def block_specs(cfg: BlockConfig) -> Params:
    """Logical-axis specs of one block, with no tensor made (the
    reference's, leaf for leaf)."""
    norm_spec = (None,) if cfg.norm == "rms" else {"w": (None,), "b": (None,)}
    attn_s: Params = {"wq": ("embed", "heads", None),
                      "wk": ("embed", "kv_heads", None),
                      "wv": ("embed", "kv_heads", None),
                      "wo": ("heads", None, "embed")}
    if cfg.attn.qk_norm:
        attn_s["q_norm"] = (None,)
        attn_s["k_norm"] = (None,)
    s: Params = {"ln1": norm_spec, "attn": attn_s, "ln2": norm_spec}
    if cfg.moe is not None:
        s["moe"] = {"router": ("embed", None),
                    "wi": ("experts", "embed", "expert_mlp"),
                    "wo": ("experts", "expert_mlp", "embed")}
        if cfg.moe.act == "swiglu":
            s["moe"]["wg"] = ("experts", "embed", "expert_mlp")
    else:
        s["mlp"] = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
        if cfg.act == "swiglu":
            s["mlp"]["wg"] = ("embed", "mlp")
    if cfg.cross_attn:
        s["ln_x"] = norm_spec
        s["xattn"] = dict(attn_s)
    return s


def prefix_specs(specs, *names):
    """Every spec leaf of ``specs`` with ``names`` in front (a stacked
    tree's leading axes)."""
    if type(specs) is tuple:
        return tuple(names) + specs
    return {k: prefix_specs(v, *names) for k, v in specs.items()}


def stack_specs(cfg: BlockConfig) -> Params:
    return prefix_specs(block_specs(cfg), "layers")


# -- stacked layers ------------------------------------------------------------

def stack_init(gen, cfg: BlockConfig, n_layers: int, device) -> Params:
    """n_layers blocks with stacked (leading 'layers' axis) params."""
    return stack_layers(lambda: block_init(gen, cfg, device), n_layers,
                        device)


def stack_layers(init_one, n_layers: int, device) -> Params:
    """``n_layers`` draws of ``init_one()`` (a params tree) stacked on a
    leading 'layers' axis, each written straight into the stacked tensors
    (one layer's tree alive at a time)."""
    first = init_one()
    stacked = _tree_map(
        lambda a: torch.empty((n_layers,) + tuple(a.shape), dtype=a.dtype,
                              device=device), first)
    for layer in range(n_layers):
        p_l = first if layer == 0 else init_one()
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


def _save_matmuls(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep every matmul's output, recompute the
    rest (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``)."""
    if op in _MATMULS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def remat(fn, policy: str):
    """``fn`` under the reference's rematerialisation ``policy``: "none"
    keeps every activation, "full" recomputes the whole of ``fn`` in the
    backward pass (``torch.utils.checkpoint``), "dots" recomputes all but
    the matmul outputs (a selective checkpoint).  Outside autograd (no
    grad mode, or no input that needs a gradient) ``fn`` runs as it is."""
    if policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(policy)
    extra = ({} if policy == "full" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_matmuls)})

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **extra)

    return wrapped


def stack_apply(stacked_p, cfg: BlockConfig, x, positions, caches=None,
                cross_kv=None, cross_len=None, remat_policy: str = "none"):
    """Apply the blocks in order (unrolled; each layer's tiles are named
    ``<scope>.<layer>.<module>.<weight>``).

    caches: stacked per-layer caches (dict of (L, ...) tensors) or None.
    Each layer updates its K/V pages and its fill marker in place through
    views of the stacked tensors; the returned caches are the same dict.
    cross_kv: stacked (k, v), each (L, B, S_src, kv_eff, hd), or None.
    remat_policy: each layer under :func:`remat` (the training path; a
    cache's in-place writes must not be recomputed, so caches take
    "none").
    Returns (x, caches, aux), ``aux`` the layers' load-balance losses
    summed in layer order from an f32 zero, as the reference's scan.
    """
    if caches is not None and remat_policy != "none":
        raise ValueError("remat recomputes in-place cache writes; the "
                         "cached (inference) path takes remat 'none'")
    n_layers = stacked_p["attn"]["wq"].shape[0]

    def one_layer(p_l, xc, xkv_l, cache_l):
        return block(p_l, cfg, xc, positions, cache=cache_l, cross_kv=xkv_l,
                     cross_len=cross_len)

    one_layer = remat(one_layer, remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(n_layers):
        p_l = _tree_map(lambda a, ll=layer: a[ll], stacked_p)
        cache_l = ({k: c[layer] for k, c in caches.items()}
                   if caches is not None else None)
        xkv_l = ((cross_kv[0][layer], cross_kv[1][layer])
                 if cross_kv is not None else None)
        with xbar.scope(layer):   # names this layer's resident tiles
            x, _, a = one_layer(p_l, x, xkv_l, cache_l)
        aux = aux + a
    return x, caches, aux


# -- embeddings / head ----------------------------------------------------------

def embed_init(gen, vocab: int, d_model: int, device) -> Params:
    return {"tok": L.normal(gen, (vocab, d_model), 0.02, device)}


def embed(p, tokens):
    e = shd.embedding(p["tok"], tokens.to(torch.int64))
    return lc(e, ("batch", "seq", "act_embed"))


def unembed(p, x, head=None):
    w = head if head is not None else p["tok"].T
    logits = shd.einsum("bsd,dv->bsv", x, w.to(x.dtype))
    return lc(logits, ("batch", None, "vocab"))


def xent_loss(logits, labels, mask=None, vocab: Optional[int] = None):
    """Cross entropy with f32 accumulation over a (possibly padded)
    vocab: the padding columns get -1e30 before the logsumexp, and a
    ``mask`` weights each position (the mean over the mask's sum, at
    least 1)."""
    lg = logits.to(torch.float32)
    if vocab is not None and vocab < lg.shape[-1]:
        pad = torch.zeros((lg.shape[-1],), dtype=torch.float32,
                          device=lg.device)
        pad[vocab:] = -1e30
        lg = lg + pad
    lse = shd.logsumexp(lg)
    gold = shd.pick(lg, labels.to(torch.int64))
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return torch.div(nll.sum(), torch.clamp(mask.sum(), min=1.0))
    return nll.mean()
