"""Abstract input builders for every (architecture x shape) dry-run
cell, as the reference's ``configs/inputs.py``.

``input_specs(model, shape)`` returns (kind, args, logical_specs):
  * kind: "train" | "prefill" | "decode" — which step function to run,
  * args: a tree of ``meta`` tensors (shape and dtype, no storage), the
    port's ``ShapeDtypeStruct``s,
  * logical_specs: the matching tree of logical-axis tuples.

Modality frontends are stubs, as in the reference: whisper gets
precomputed frame embeddings, qwen2-vl precomputed patch embeddings and
(t, h, w) M-RoPE ids.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.configs import ShapeSpec
from repro_torch.models.model import Model, ModelConfig

VLM_PATCHES = 256


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract(fn, *args, **kwargs):
    """``jax.eval_shape``: what ``fn`` returns, as meta tensors.  ``fn``
    runs under a ``FakeTensorMode``, so nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn(*args, **kwargs)
    return tree.map(lambda t: _meta(t.shape, t.dtype), out)


def make_batch(cfg: ModelConfig, shape: ShapeSpec
               ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Training/prefill batch (meta tensors) + logical specs."""
    b, s = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    specs: Dict[str, Any] = {}
    i64 = torch.int64
    if cfg.family == "vlm":
        s_text = s - VLM_PATCHES
        batch["tokens"] = _meta((b, s_text), i64)
        specs["tokens"] = ("batch", "seq")
        batch["vis_emb"] = _meta((b, VLM_PATCHES, cfg.d_model), cfg.dtype)
        specs["vis_emb"] = ("batch", "seq", "act_embed")
        batch["positions_thw"] = _meta((b, s, 3), i64)
        specs["positions_thw"] = ("batch", "seq", None)
        if shape.kind == "train":
            batch["labels"] = _meta((b, s_text), i64)
            specs["labels"] = ("batch", "seq")
    else:
        batch["tokens"] = _meta((b, s), i64)
        specs["tokens"] = ("batch", "seq")
        if shape.kind == "train":
            batch["labels"] = _meta((b, s), i64)
            specs["labels"] = ("batch", "seq")
        if cfg.family == "encdec":
            batch["enc_emb"] = _meta((b, s, cfg.d_model), cfg.dtype)
            specs["enc_emb"] = ("batch", "seq", "act_embed")
    return batch, specs


def make_cache(model: Model, shape: ShapeSpec):
    """Abstract cache (meta tensors) + logical specs for prefill/decode."""
    cfg = model.cfg
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        cache = abstract(model.init_cache, b, s, src_len=s)
    else:
        cache = abstract(model.init_cache, b, s)
    return cache, model.cache_specs()


def input_specs(model: Model, shape: ShapeSpec):
    """(kind, args, logical_specs) for the step function of this cell."""
    cfg = model.cfg
    if shape.kind == "train":
        batch, specs = make_batch(cfg, shape)
        return "train", (batch,), (specs,)
    if shape.kind == "prefill":
        batch, bspecs = make_batch(cfg, shape)
        cache, cspecs = make_cache(model, shape)
        return "prefill", (batch, cache), (bspecs, cspecs)
    # decode: one new token against a seq_len-deep cache
    b = shape.global_batch
    tokens = _meta((b, 1), torch.int64)
    tspecs = ("batch", None)
    cache, cspecs = make_cache(model, shape)
    return "decode", (tokens, cache), (tspecs, cspecs)
