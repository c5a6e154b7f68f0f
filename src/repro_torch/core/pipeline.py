"""Deep-net schedule algebra (PyTorch port's copy).

The reference's ``repro.core.pipeline`` holds the event-level deep-net
schedule and its functional executor (not ported yet); the hot-swap
device-time model needs only :func:`streaming_speedup`, which is pure
arithmetic and lives here as the port's own copy.
"""
from __future__ import annotations


def streaming_speedup(t_compute: float, t_dma: float, n_tiles: int) -> float:
    """Deep-net schedule applied to weight streaming.

    read  == compute of tile l             (t_compute)
    write == transfer of tile l+1's weights (t_dma)

    Serial: n * (t_dma + t_compute); pipelined: t_dma + n * max(...).
    """
    serial = n_tiles * (t_dma + t_compute)
    piped = t_dma + n_tiles * max(t_dma, t_compute)
    return 1.0 - piped / serial
