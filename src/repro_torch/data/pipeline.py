"""Deterministic, seekable, shardable synthetic token pipeline (PyTorch).

Fault-tolerance contract, as in the reference: ``batch_at(step)`` is a
pure function of (seed, step), so a replacement host regenerates exactly
the batch its failed predecessor would have produced, with no loader
state to checkpoint or replay.

The synthetic language is the reference's structured Markov stream:
token t+1 is ``perm[token t]`` for a fixed random permutation, replaced
by a uniform token with probability ``noise``, with the marker 0 every
``period`` positions.  ``perm`` is the reference's own
(``np.random.default_rng(seed).permutation``), bit for bit.  The
reference draws the start tokens, the noise mask and the noise tokens
with ``jax.random`` keyed on (seed, step), which torch cannot replay:
here they come from a CPU ``torch.Generator`` seeded from (seed, step)
through numpy's ``SeedSequence``, in the same order and at the same
rates, so the batches keep the contract but not the reference's bits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1       # fraction of tokens replaced by uniform noise
    period: int = 17         # syntax-marker period


def _step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of batch ``step`` under ``seed``: a function of
    both alone."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


class SyntheticLM:
    """next = perm[cur] with prob 1-noise else uniform; marker every
    period.  Batches are made on the CPU and land on ``device`` (CUDA by
    default)."""

    def __init__(self, cfg: DataConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        self.perm = torch.from_numpy(
            rng.permutation(cfg.vocab).astype(np.int32))

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        gen = _step_generator(cfg.seed, step)
        b, s = cfg.global_batch, cfg.seq_len
        start = torch.randint(0, cfg.vocab, (b, 1), generator=gen,
                              dtype=torch.int64)
        perm = self.perm.to(torch.int64)
        toks = [start[:, 0]]
        cur = start[:, 0]
        for _ in range(s - 1):       # token_t = perm^t(start)
            cur = perm[cur]
            toks.append(cur)
        seq = torch.stack(toks, dim=1)
        noise_mask = torch.rand((b, s), generator=gen) < cfg.noise
        noise_tok = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                  dtype=torch.int64)
        seq = torch.where(noise_mask, noise_tok, seq)
        marker = (torch.arange(s) % cfg.period) == 0
        seq = torch.where(marker[None, :], 0, seq).to(torch.int32)
        return {"tokens": seq[:, :-1].contiguous().to(self.device),
                "labels": seq[:, 1:].contiguous().to(self.device)}

    def host_shard_at(self, step: int, host_id: int, n_hosts: int
                      ) -> Dict[str, torch.Tensor]:
        """Per-host slice of the global batch (deterministic by host
        id)."""
        full = self.batch_at(step)
        per = self.cfg.global_batch // n_hosts
        lo = host_id * per
        return {k: v[lo:lo + per] for k, v in full.items()}
