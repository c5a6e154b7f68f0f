"""Model builder for all six families of the reference (PyTorch): dense,
MoE, VLM (qwen2-vl: M-RoPE, patch embeddings in front of the tokens),
encoder-decoder (whisper: LayerNorm blocks, cross-attention), RWKV6 and
the Zamba2 hybrid.

``build_model(cfg, device=None)`` returns a ``Model`` with the
reference's functional API:

  init(seed) -> params                  param_specs() -> logical axes
  loss_fn(params, batch) -> (loss, metrics)             [train shapes]
  prefill(params, batch, cache) -> (logits, cache)
  decode_step(params, tokens, cache) -> (logits, cache)
  init_cache(batch, max_len[, src_len]) / cache_specs() /
  init_paged_cache(...) / paged_cache_specs() / copy_paged_page(...)

The model lives on one device, CUDA unless ``device="cpu"`` is asked
for.  The crossbar backend serves the transformer families; the
recurrent ones are digital, as in the reference.  ``loss_fn`` is the
training path: digital on any backend (as in the reference), under
autograd, each layer under ``cfg.remat``; ``prefill`` and
``decode_step`` run under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import executor as xbar
from repro_torch.core.engine import EngineConfig
from repro_torch.core.executor import CrossbarExecutor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import logical_constraint as lc
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.layers import AttnConfig, MoEConfig


def _pad_vocab(v: int, mult: int = 256) -> int:
    return -(-v // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|vlm|encdec|rwkv6|zamba2
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv: int = 0
    d_ff: int = 0
    vocab: int = 32000
    head_dim: int = 128
    act: str = "swiglu"
    qk_norm: bool = False
    norm: str = "rms"              # block norm: "rms" | "ln"
    rope_theta: float = 1e6
    kv_repeat: int = 1             # Megatron KV replication
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity: float = 1.25
    ssm_state: int = 64
    ssm_head_dim: int = 64
    attn_every: int = 6            # zamba2 shared-attention period
    q_chunk: int = 0               # chunked attention (0 = off)
    lin_chunk: int = 16            # GLA chunk for rwkv/mamba
    remat: str = "none"            # none | full | dots (training only)
    dtype: Any = torch.bfloat16    # activation/compute dtype
    kv_dtype: Any = None           # KV-cache storage dtype (None = dtype);
    # torch.float8_e4m3fn halves the cache, upcast to dtype inside the dot
    tie_embeddings: bool = False   # logits through the embedding (no head)
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
            mrope=(self.family == "vlm"), q_chunk=self.q_chunk,
            paged_kernel=self.paged_kernel,
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
                             moe=self.moe, norm=self.norm,
                             cross_attn=(self.family == "encdec"))

    @property
    def rwkv(self) -> R.RWKVConfig:
        return R.RWKVConfig(d_model=self.d_model, n_layers=self.n_layers,
                            head_dim=self.ssm_head_dim, vocab=self.vocab,
                            ffn_mult=self.d_ff / self.d_model,
                            chunk=self.lin_chunk)

    @property
    def mamba(self) -> S.Mamba2Config:
        return S.Mamba2Config(d_model=self.d_model, d_state=self.ssm_state,
                              head_dim=self.ssm_head_dim,
                              chunk=self.lin_chunk)

    # zamba2 layout: n_super super-blocks of (shared attn + attn_every
    # mamba layers) + trailing mamba layers
    @property
    def zamba_layout(self) -> Tuple[int, int]:
        n_super = self.n_layers // self.attn_every
        trailing = self.n_layers - n_super * self.attn_every
        return n_super, trailing


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Any
    prefill: Any
    decode_step: Any
    init_cache: Any
    executor: Optional[CrossbarExecutor] = None  # crossbar backend only
    # paged-KV serving (transformer families; encdec's refuses)
    init_paged_cache: Any = None
    copy_paged_page: Any = None
    loss_fn: Any = None
    # logical axes (distributed/sharding.py), trees of tuples, no tensor
    param_specs: Any = None
    cache_specs: Any = None
    paged_cache_specs: Any = None


def _stack(trees):
    """Nested dicts of tensors -> one dict of the leaves stacked along a
    new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i):
    """Entry ``i`` of every leaf's leading axis (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _no_grad(fn):
    return torch.no_grad()(fn)


# ---------------------------------------------------------------------------
# transformer families (dense / moe / vlm / encdec)
# ---------------------------------------------------------------------------

def _build_transformer(cfg: ModelConfig, device: torch.device) -> Model:
    bc = cfg.block_cfg
    enc_bc = dataclasses.replace(
        bc, cross_attn=False,
        attn=dataclasses.replace(bc.attn, causal=False))
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
        if not cfg.tie_embeddings:
            p["head"] = L.normal(gen, (cfg.d_model, pv),
                                 cfg.d_model ** -0.5, device)
        if cfg.family == "encdec":
            p["enc_blocks"] = T.stack_init(gen, enc_bc, cfg.n_layers, device)
            p["enc_ln_f"] = torch.ones((cfg.d_model,), device=device)
        return p

    def param_specs():
        p: Dict[str, Any] = {}
        p["embed"] = {"tok": ("vocab", "embed")}
        p["blocks"] = T.stack_specs(bc)
        p["ln_f"] = (None,)
        if not cfg.tie_embeddings:
            p["head"] = ("embed", "vocab")
        if cfg.family == "encdec":
            p["enc_blocks"] = T.stack_specs(enc_bc)
            p["enc_ln_f"] = (None,)
        return p

    def cache_specs():
        out = {"layers": T.prefix_specs(L.cache_specs(bc.attn), "layers")}
        if cfg.family == "encdec":
            kv_spec = ("layers", "batch", "kv_seq", "act_kv_heads", None)
            out["cross_kv"] = {"k": kv_spec, "v": kv_spec}
        return out

    def paged_cache_specs():
        return {"layers": T.prefix_specs(L.paged_cache_specs(bc.attn),
                                         "layers")}

    def _positions(batch, sq):
        if cfg.family == "vlm":
            return batch["positions_thw"]
        b = batch["tokens"].shape[0]
        return torch.arange(sq, device=device)[None].expand(b, sq)

    def _trunk(p, x, positions, caches=None, cross_kv=None):
        remat = cfg.remat if caches is None else "none"
        with xbar.scope("blocks"):
            return T.stack_apply(p["blocks"], bc, x, positions,
                                 caches=caches, cross_kv=cross_kv,
                                 remat_policy=remat)

    def _encode(p, batch, remat="none"):
        """The encoder over ``enc_emb``, bidirectional; its final norm is
        an RMSNorm under any block norm, as in the reference."""
        enc = batch["enc_emb"].to(cfg.dtype)
        b, s = enc.shape[:2]
        pos = torch.arange(s, device=device)[None].expand(b, s)
        with xbar.scope("enc_blocks"):
            h, _, _ = T.stack_apply(p["enc_blocks"], enc_bc, enc, pos,
                                    remat_policy=remat)
        return L.rmsnorm(h, p["enc_ln_f"])

    def _cross_kv(p, enc_out):
        """Each decoder layer's cross-attention K/V from the encoder
        output, digitally (``xattn.wk``/``wv`` are never programmed):
        stacked (L, B, S_src, kv_eff, hd) each."""
        xw = p["blocks"]["xattn"]
        ks, vs = [], []
        for layer in range(cfg.n_layers):
            ks.append(shd.einsum("bsd,dhk->bshk", enc_out,
                                 xw["wk"][layer].to(enc_out.dtype)))
            vs.append(shd.einsum("bsd,dhk->bshk", enc_out,
                                 xw["wv"][layer].to(enc_out.dtype)))
        return torch.stack(ks), torch.stack(vs)

    def _logits(p, x):
        x = lc(x, ("batch", "seq_act", "act_embed"))  # SP gather point
        if cfg.tie_embeddings:   # digital, even on the crossbar backend
            return T.unembed(p["embed"], x)
        logits = xbar.crossbar_linear(
            x, p["head"], "head",
            digital=lambda: T.unembed(p["embed"], x, head=p["head"]))
        return lc(logits, ("batch", None, "vocab"))

    def _embed_inputs(p, batch):
        x = T.embed(p["embed"], batch["tokens"]).to(cfg.dtype)
        if cfg.family == "vlm" and "vis_emb" in batch:
            x = torch.cat([batch["vis_emb"].to(cfg.dtype), x], dim=1)
        return x

    def loss_fn(params, batch):
        """Mean next-token cross entropy over ``batch["labels"]`` (masked
        by ``loss_mask`` if given), plus ``0.01 * aux / n_layers`` for
        an MoE; the VLM's visual prefix is dropped before the head."""
        x = _embed_inputs(params, batch)
        cross_kv = None
        if cfg.family == "encdec":
            cross_kv = _cross_kv(params, _encode(params, batch, cfg.remat))
        pos = _positions(batch, x.shape[1])
        h, _, aux = _trunk(params, x, pos, cross_kv=cross_kv)
        h = L.rmsnorm(h, params["ln_f"])
        if cfg.family == "vlm" and "vis_emb" in batch:
            h = h[:, batch["vis_emb"].shape[1]:]
        logits = _logits(params, h)
        loss = T.xent_loss(logits, batch["labels"], batch.get("loss_mask"),
                           vocab=cfg.vocab)
        if cfg.moe is not None:
            loss = loss + torch.div(0.01 * aux, cfg.n_layers)
        return loss, {"loss": loss, "aux": aux}

    def init_cache(batch: int, max_len: int, src_len: int = 0):
        one = L.init_cache(bc.attn, batch, max_len,
                           dtype=cfg.kv_dtype or cfg.dtype, device=device)
        out = {"layers": {k: L.cache_zeros((cfg.n_layers,) + tuple(v.shape),
                                           v.dtype, device)
                          for k, v in one.items()}}
        if cfg.family == "encdec" and src_len:
            shape = (cfg.n_layers, batch, src_len, bc.attn.kv_eff,
                     bc.attn.head_dim)
            out["cross_kv"] = {
                "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
        return out

    def init_paged_cache(batch: int, max_len: int, n_pages: int,
                         page_size: int):
        """Paged KV cache: physical page pools + per-row page tables,
        stacked across layers like ``init_cache``."""
        if cfg.family == "encdec":
            raise ValueError("paged KV serving targets decoder-only "
                             "families (no cross-attention cache)")
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
        """Prefill the KV cache with a full prompt (the patch embeddings
        first for a VLM; the encoder first for an encoder-decoder, whose
        cross K/V the cache then holds); returns the last logits."""
        x = _embed_inputs(params, batch)
        pos = _positions(batch, x.shape[1])
        cross_kv = None
        if cfg.family == "encdec":
            cross_kv = _cross_kv(params, _encode(params, batch))
        h, new_layers, _ = _trunk(params, x, pos, caches=cache["layers"],
                                  cross_kv=cross_kv)
        h = L.rmsnorm(h, params["ln_f"])
        cache = dict(cache, layers=new_layers)
        if cfg.family == "encdec":
            cache["cross_kv"] = {"k": cross_kv[0].to(cfg.dtype),
                                 "v": cross_kv[1].to(cfg.dtype)}
        return _logits(params, h[:, -1:]), cache

    def decode_step(params, tokens, cache):
        x = T.embed(params["embed"], tokens).to(cfg.dtype)
        offset = cache["layers"]["len"][0]
        sq = tokens.shape[1]
        pos = (offset[:, None].to(torch.int64)
               + torch.arange(sq, device=device)[None])
        if cfg.family == "vlm":   # text positions: t == h == w
            pos = pos[..., None].expand(*pos.shape, 3)
        ckv = cache.get("cross_kv")
        cross_kv = (ckv["k"], ckv["v"]) if ckv is not None else None
        h, new_layers, _ = _trunk(params, x, pos, caches=cache["layers"],
                                  cross_kv=cross_kv)
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
            return _no_grad(fn)

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
                 copy_paged_page=copy_paged_page, loss_fn=loss_fn,
                 param_specs=param_specs, cache_specs=cache_specs,
                 paged_cache_specs=paged_cache_specs)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _build_rwkv(cfg: ModelConfig, device: torch.device) -> Model:
    rc = cfg.rwkv
    pv = cfg.padded_vocab

    def init(seed: int = 0) -> Dict[str, Any]:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        return {
            "embed": T.embed_init(gen, pv, cfg.d_model, device),
            "blocks": T.stack_layers(lambda: R.block_init(gen, rc, device),
                                     cfg.n_layers, device),
            "ln_f": torch.ones((cfg.d_model,), device=device),
            "head": L.normal(gen, (cfg.d_model, pv), cfg.d_model ** -0.5,
                             device),
        }

    def param_specs():
        return {"embed": {"tok": ("vocab", "embed")},
                "blocks": T.prefix_specs(R.block_specs(rc), "layers"),
                "ln_f": (None,), "head": ("embed", "vocab")}

    def cache_specs():
        return {"layers": T.prefix_specs(R.state_specs(rc), "layers")}

    def _run(params, x, states, decode, remat="none"):
        one = T.remat(lambda p_l, xc, st_l: R.block(p_l, rc, xc, st_l,
                                                    decode=decode), remat)
        outs = []
        for layer in range(cfg.n_layers):
            x, new_st = one(_index(params["blocks"], layer), x,
                            _index(states, layer))
            outs.append(new_st)
        return x, _stack(outs)

    def init_cache(batch: int, max_len: int = 0):
        one = R.init_state(rc, batch, device=device)
        return {"layers": {k: torch.zeros((cfg.n_layers,) + tuple(v.shape),
                                          dtype=v.dtype, device=device)
                           for k, v in one.items()}}

    def _head(params, h):
        h = L.rmsnorm(h, params["ln_f"])
        return T.unembed(params["embed"], h, head=params["head"])

    def loss_fn(params, batch):
        x = T.embed(params["embed"], batch["tokens"]).to(cfg.dtype)
        states = init_cache(x.shape[0])["layers"]
        h, _ = _run(params, x, states, decode=False, remat=cfg.remat)
        loss = T.xent_loss(_head(params, h), batch["labels"],
                           batch.get("loss_mask"), vocab=cfg.vocab)
        return loss, {"loss": loss}

    def prefill(params, batch, cache):
        x = T.embed(params["embed"], batch["tokens"]).to(cfg.dtype)
        h, new_states = _run(params, x, cache["layers"], decode=False)
        return _head(params, h[:, -1:]), {"layers": new_states}

    def decode_step(params, tokens, cache):
        x = T.embed(params["embed"], tokens).to(cfg.dtype)
        h, new_states = _run(params, x, cache["layers"], decode=True)
        return _head(params, h), {"layers": new_states}

    return Model(cfg, device, init, _no_grad(prefill), _no_grad(decode_step),
                 init_cache, loss_fn=loss_fn, param_specs=param_specs,
                 cache_specs=cache_specs)


# ---------------------------------------------------------------------------
# Zamba2 hybrid
# ---------------------------------------------------------------------------

def _build_zamba(cfg: ModelConfig, device: torch.device) -> Model:
    mc = cfg.mamba
    bc = dataclasses.replace(cfg.block_cfg, moe=None)
    n_super, trailing = cfg.zamba_layout
    pv = cfg.padded_vocab

    def init(seed: int = 0) -> Dict[str, Any]:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))

        def mambas(n):
            return T.stack_layers(
                lambda: S.mamba2_block_init(gen, mc, device), n, device)

        return {
            "embed": T.embed_init(gen, pv, cfg.d_model, device),
            "shared_attn": T.block_init(gen, bc, device),  # ONE shared block
            "supers": T.stack_layers(lambda: mambas(cfg.attn_every),
                                     n_super, device),
            "tail": mambas(max(trailing, 1)),
            "ln_f": torch.ones((cfg.d_model,), device=device),
            "head": L.normal(gen, (cfg.d_model, pv), cfg.d_model ** -0.5,
                             device),
        }

    def param_specs():
        ms = S.mamba2_block_specs(mc)
        return {"embed": {"tok": ("vocab", "embed")},
                "shared_attn": T.block_specs(bc),
                "supers": T.prefix_specs(ms, "layers", "layers"),
                "tail": T.prefix_specs(ms, "layers"),
                "ln_f": (None,), "head": ("embed", "vocab")}

    def cache_specs():
        mcs = S.mamba2_state_specs(mc)
        return {"attn": T.prefix_specs(L.cache_specs(bc.attn), "layers"),
                "mamba": T.prefix_specs(mcs, "layers", "layers"),
                "tail": T.prefix_specs(mcs, "layers")}

    def init_cache(batch: int, max_len: int):
        attn = L.init_cache(bc.attn, batch, max_len,
                            dtype=cfg.kv_dtype or cfg.dtype, device=device)
        m_state = S.mamba2_state(mc, batch, device=device)

        def zeros(lead, tree):
            return {k: L.cache_zeros(lead + tuple(v.shape), v.dtype, device)
                    for k, v in tree.items()}

        return {"attn": zeros((n_super,), attn),
                "mamba": zeros((n_super, cfg.attn_every), m_state),
                "tail": zeros((max(trailing, 1),), m_state)}

    def _run(params, x, cache, positions, decode, remat="none"):
        """Each super-block: the shared attention block on its own KV
        cache (written in place), then ``attn_every`` Mamba2 blocks; then
        the trailing Mamba2 blocks.  ``cache["attn"]`` None (the loss
        path) gives each application a fresh zero cache of the window's
        depth inside the super-block, as the reference's ``loss_fn``
        passes, so that autograd (and a recomputing ``remat``) sees
        each cache written once."""

        def super_body(p_super, m_states, xc, attn_cache):
            if attn_cache is None:
                attn_cache = L.init_cache(
                    bc.attn, xc.shape[0], xc.shape[1],
                    dtype=cfg.kv_dtype or cfg.dtype, device=device, like=xc)
            xc, _, _ = T.block(params["shared_attn"], bc, xc, positions,
                               cache=attn_cache)
            sts = []
            for j in range(cfg.attn_every):
                xc, st = S.mamba2_block(_index(p_super, j), mc, xc,
                                        _index(m_states, j), decode=decode)
                sts.append(st)
            return xc, _stack(sts)

        super_body = T.remat(super_body, remat)
        new_m = []
        for i in range(n_super):
            attn_cache = (None if cache["attn"] is None
                          else _index(cache["attn"], i))
            x, sts = super_body(_index(params["supers"], i),
                                _index(cache["mamba"], i), x, attn_cache)
            new_m.append(sts)
        new_tail = cache["tail"]
        if trailing > 0:
            sts = []
            for j in range(trailing):
                x, st = S.mamba2_block(_index(params["tail"], j), mc, x,
                                       _index(cache["tail"], j),
                                       decode=decode)
                sts.append(st)
            new_tail = _stack(sts)
        return x, {"attn": cache["attn"], "mamba": _stack(new_m),
                   "tail": new_tail}

    def _head(params, h):
        h = L.rmsnorm(h, params["ln_f"])
        return T.unembed(params["embed"], h, head=params["head"])

    def loss_fn(params, batch):
        x = T.embed(params["embed"], batch["tokens"]).to(cfg.dtype)
        b, sq = batch["tokens"].shape
        cache = dict(init_cache(b, 0), attn=None)
        pos = torch.arange(sq, device=device)[None].expand(b, sq)
        h, _ = _run(params, x, cache, pos, decode=False, remat=cfg.remat)
        loss = T.xent_loss(_head(params, h), batch["labels"],
                           batch.get("loss_mask"), vocab=cfg.vocab)
        return loss, {"loss": loss}

    def prefill(params, batch, cache):
        x = T.embed(params["embed"], batch["tokens"]).to(cfg.dtype)
        b, sq = batch["tokens"].shape
        pos = torch.arange(sq, device=device)[None].expand(b, sq)
        h, new_cache = _run(params, x, cache, pos, decode=False)
        return _head(params, h[:, -1:]), new_cache

    def decode_step(params, tokens, cache):
        x = T.embed(params["embed"], tokens).to(cfg.dtype)
        # row 0's marker of the first application, for every row (as the
        # reference); a copy, since the blocks advance "len" in place
        offset = cache["attn"]["len"][0, 0].clone()
        pos = offset.to(torch.int64).reshape(1, 1).expand(tokens.shape)
        h, new_cache = _run(params, x, cache, pos, decode=True)
        return _head(params, h), new_cache

    return Model(cfg, device, init, _no_grad(prefill), _no_grad(decode_step),
                 init_cache, loss_fn=loss_fn, param_specs=param_specs,
                 cache_specs=cache_specs)


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """Build the model on ``device`` (CUDA by default; ``"cpu"`` must be
    asked for)."""
    if cfg.backend not in ("digital", "crossbar"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    dev = resolve_device(device)
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        return _build_transformer(cfg, dev)
    if cfg.backend == "crossbar":
        raise ValueError(
            f"backend='crossbar' supports transformer families only, "
            f"not {cfg.family!r}")
    if cfg.family == "rwkv6":
        return _build_rwkv(cfg, dev)
    if cfg.family == "zamba2":
        return _build_zamba(cfg, dev)
    raise ValueError(f"unknown family {cfg.family}")
