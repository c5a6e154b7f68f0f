"""Shape-checked entry point + two-lane dispatch for paged attention.

Two lanes, dispatched by window size (``lane="auto"``):

* **scratch** (``paged_attention_scratch``) — gather-then-SDPA with an
  exact softmax; the small-window path.
* **streamed** (``paged_attention_streamed``) — online softmax over
  blocks of ``block_pages`` pages; selected when the table is at least
  ``stream_min_pages`` pages wide (0 disables it).

Every dispatch lands in the global telemetry registry as
``crossstack_dispatch_total{path=paged_scratch|paged_streamed|
paged_fallback, geometry}``; ``paged_path_calls`` is the summed view.
Unlike the reference there is no probe-compile-and-fall-back path (that
answers a TPU lowering risk): a streamed-lane failure raises, and
``paged_fallback`` stays a counter that reads 0.

Page tables may ALIAS: several rows' tables may point at one physical
page, and the read-only gather makes that indistinguishable from
private copies.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

from repro_torch import obs
from repro_torch.kernels.paged_attention.kernel import (
    paged_attention_scratch, paged_attention_streamed)

_DISPATCH = "crossstack_dispatch_total"


def _count_dispatch(path: str, p_seq: int, ps: int) -> None:
    obs.registry().counter(
        _DISPATCH,
        help="engine.matmul dispatches per execution path, labeled by KxN "
             "geometry",
    ).inc(path=path, geometry=f"{p_seq}x{ps}")


class _PagedPathCallsView(Mapping):
    """Read-only view over the paged-attention dispatch counters, summed
    across geometries (``paged_path_calls["paged_streamed"]``)."""

    _PATHS = ("paged_scratch", "paged_streamed", "paged_fallback")

    def __getitem__(self, key: str) -> int:
        if key not in self._PATHS:
            raise KeyError(key)
        return int(obs.registry().total(_DISPATCH, path=key))

    def __iter__(self):
        return iter(self._PATHS)

    def __len__(self) -> int:
        return len(self._PATHS)

    def __eq__(self, other) -> bool:
        if isinstance(other, (Mapping, dict)):
            return dict(self) == dict(other)
        return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return f"paged_path_calls({dict(self)})"


paged_path_calls = _PagedPathCallsView()


def paged_attention(q, k_pages, v_pages, page_table, kv_len, q_offset,
                    *, causal: bool = True, lane: str = "auto",
                    stream_min_pages: int = 0, block_pages: int = 16
                    ) -> torch.Tensor:
    """Ragged paged decode attention.

    ``lane``: ``"auto"`` (streamed iff ``stream_min_pages > 0`` and the
    table is at least that many pages wide), ``"scratch"``, or
    ``"streamed"``.  ``block_pages`` sizes the streamed lane's page
    blocks (clamped to a divisor of the table width).
    """
    b, sq, hq, hd = q.shape
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v page pools disagree: {tuple(k_pages.shape)} "
                         f"vs {tuple(v_pages.shape)}")
    _, ps, kv, hd2 = k_pages.shape
    if hd2 != hd:
        raise ValueError(f"head_dim mismatch: q {hd} vs pages {hd2}")
    if hq % kv:
        raise ValueError(f"n_heads {hq} not a multiple of kv heads {kv}")
    if page_table.shape[0] != b:
        raise ValueError(f"page_table rows {page_table.shape[0]} != "
                         f"batch {b}")
    if kv_len.shape != (b,) or q_offset.shape != (b,):
        raise ValueError(f"kv_len/q_offset want shape ({b},), got "
                         f"{tuple(kv_len.shape)}/{tuple(q_offset.shape)}")
    if lane not in ("auto", "scratch", "streamed"):
        raise ValueError(f"unknown lane {lane!r} (want auto | scratch | "
                         f"streamed)")
    p_seq = page_table.shape[1]
    if lane == "auto":
        lane = ("streamed" if stream_min_pages > 0
                and p_seq >= stream_min_pages else "scratch")
    page_table = page_table.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32).contiguous()
    q_offset = q_offset.to(torch.int32).contiguous()
    q = q.contiguous()
    _count_dispatch(f"paged_{lane}", p_seq, ps)
    if lane == "streamed":
        return paged_attention_streamed(q, k_pages, v_pages, page_table,
                                        kv_len, q_offset, causal=causal,
                                        block_pages=block_pages)
    return paged_attention_scratch(q, k_pages, v_pages, page_table, kv_len,
                                   q_offset, causal=causal)
