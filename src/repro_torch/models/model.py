"""Model builder for the decoder families, dense and MoE (PyTorch).

``build_model(cfg, device=None)`` returns a ``Model`` with the
reference's functional API for inference:

  init(seed) -> params
  prefill(params, batch, cache) -> (logits, cache)
  decode_step(params, tokens, cache) -> (logits, cache)
  init_cache(batch, max_len) / init_paged_cache(...) / copy_paged_page(...)

The model lives on one device, CUDA unless ``device="cpu"`` is asked
for.  The other families (VLM, encoder-decoder, recurrent) and the
training path are later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core import executor as xbar
from repro_torch.core.engine import EngineConfig
from repro_torch.core.executor import CrossbarExecutor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import AttnConfig, MoEConfig


def _pad_vocab(v: int, mult: int = 256) -> int:
    return -(-v // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # "dense" | "moe" (others: later slices)
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv: int = 0
    d_ff: int = 0
    vocab: int = 32000
    head_dim: int = 128
    act: str = "swiglu"
    qk_norm: bool = False
    rope_theta: float = 1e6
    kv_repeat: int = 1             # Megatron KV replication
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity: float = 1.25
    q_chunk: int = 0               # chunked attention (0 = off)
    dtype: Any = torch.bfloat16    # activation/compute dtype
    kv_dtype: Any = None           # KV-cache storage dtype (None = dtype);
    # torch.float8_e4m3fn halves the cache, upcast to dtype inside the dot
    paged_kernel: bool = False     # paged decode via the CUDA kernels
    paged_stream_pages: int = 0    # streamed-lane threshold in pages
    paged_block_pages: int = 16    # pages per streamed block
    backend: str = "digital"       # "digital" | "crossbar" (weight-resident)
    xbar: EngineConfig = EngineConfig(mode="deepnet")  # crossbar-backend cfg

    @property
    def padded_vocab(self) -> int:
        return _pad_vocab(self.vocab)

    @property
    def attn(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
            head_dim=self.head_dim, qk_norm=self.qk_norm,
            rope_theta=self.rope_theta, kv_repeat=self.kv_repeat,
            q_chunk=self.q_chunk, paged_kernel=self.paged_kernel,
            paged_stream_pages=self.paged_stream_pages,
            paged_block_pages=self.paged_block_pages)

    @property
    def moe(self) -> Optional[MoEConfig]:
        if self.moe_experts == 0:
            return None
        return MoEConfig(self.moe_experts, self.moe_top_k,
                         self.moe_capacity, self.act)

    @property
    def block_cfg(self) -> T.BlockConfig:
        return T.BlockConfig(attn=self.attn, d_ff=self.d_ff, act=self.act,
                             moe=self.moe)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Any
    prefill: Any
    decode_step: Any
    init_cache: Any
    executor: Optional[CrossbarExecutor] = None  # crossbar backend only
    init_paged_cache: Any = None
    copy_paged_page: Any = None


def _build_transformer(cfg: ModelConfig, device: torch.device) -> Model:
    bc = cfg.block_cfg
    pv = cfg.padded_vocab
    executor = (CrossbarExecutor(cfg.xbar) if cfg.backend == "crossbar"
                else None)

    def init(seed: int = 0) -> Dict[str, Any]:
        """Random params from ``seed`` (a device-side torch.Generator),
        stored f32 like the reference's."""
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        p: Dict[str, Any] = {}
        p["embed"] = T.embed_init(gen, pv, cfg.d_model, device)
        p["blocks"] = T.stack_init(gen, bc, cfg.n_layers, device)
        p["ln_f"] = torch.ones((cfg.d_model,), device=device)
        p["head"] = L.normal(gen, (cfg.d_model, pv), cfg.d_model ** -0.5,
                             device)
        return p

    def _trunk(p, x, positions, caches=None):
        with xbar.scope("blocks"):
            return T.stack_apply(p["blocks"], bc, x, positions,
                                 caches=caches)

    def _logits(p, x):
        return xbar.crossbar_linear(
            x, p["head"], "head",
            digital=lambda: T.unembed(p["embed"], x, head=p["head"]))

    def init_cache(batch: int, max_len: int):
        one = L.init_cache(bc.attn, batch, max_len,
                           dtype=cfg.kv_dtype or cfg.dtype, device=device)
        return {"layers": {k: L.cache_zeros((cfg.n_layers,) + tuple(v.shape),
                                            v.dtype, device)
                           for k, v in one.items()}}

    def init_paged_cache(batch: int, max_len: int, n_pages: int,
                         page_size: int):
        """Paged KV cache: physical page pools + per-row page tables,
        stacked across layers like ``init_cache``."""
        one = L.paged_init_cache(bc.attn, batch, max_len, n_pages,
                                 page_size, dtype=cfg.kv_dtype or cfg.dtype,
                                 device=device)
        return {"layers": {k: L.cache_zeros((cfg.n_layers,) + tuple(v.shape),
                                            v.dtype, device)
                           for k, v in one.items()}}

    def copy_paged_page(cache, src: int, dst: int):
        """Copy-on-write plumbing: duplicate physical KV page ``src`` into
        ``dst`` in every layer, in place."""
        L.paged_copy_page(cache["layers"], int(src), int(dst))
        return cache

    def prefill(params, batch, cache):
        """Prefill the KV cache with a full prompt; returns last logits."""
        tokens = batch["tokens"]
        x = T.embed(params["embed"], tokens).to(cfg.dtype)
        sq = x.shape[1]
        pos = torch.arange(sq, device=device)[None].expand(tokens.shape[0],
                                                           sq)
        h, new_layers = _trunk(params, x, pos, caches=cache["layers"])
        h = L.rmsnorm(h, params["ln_f"])
        return _logits(params, h[:, -1:]), dict(cache, layers=new_layers)

    def decode_step(params, tokens, cache):
        x = T.embed(params["embed"], tokens).to(cfg.dtype)
        offset = cache["layers"]["len"][0]
        sq = tokens.shape[1]
        pos = (offset[:, None].to(torch.int64)
               + torch.arange(sq, device=device)[None])
        h, new_layers = _trunk(params, x, pos, caches=cache["layers"])
        h = L.rmsnorm(h, params["ln_f"])
        return _logits(params, h), dict(cache, layers=new_layers)

    def _on_crossbar(fn):
        """Inference entry points read the resident tiles; programming
        happens on the first call (or via executor.program_params).
        Inside the executor's own ``activate()`` region the caller has
        programmed and checked the tree already (the scheduler's window
        step, whose CUDA graph must hold no host work), so the call goes
        straight to the tiles."""
        if executor is None:
            return torch.no_grad()(fn)

        @torch.no_grad()
        def wrapped(params, *args, **kwargs):
            if xbar.active() is executor:
                return fn(params, *args, **kwargs)
            executor.ensure_programmed(params)
            with executor.activate():
                return fn(params, *args, **kwargs)

        return wrapped

    return Model(cfg, device, init, _on_crossbar(prefill),
                 _on_crossbar(decode_step), init_cache, executor=executor,
                 init_paged_cache=init_paged_cache,
                 copy_paged_page=copy_paged_page)


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """Build the model on ``device`` (CUDA by default; ``"cpu"`` must be
    asked for)."""
    if cfg.backend not in ("digital", "crossbar"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"model family {cfg.family!r} is a later slice of the PyTorch "
            f"port; it builds the dense and MoE decoder families")
    return _build_transformer(cfg, resolve_device(device))
