"""Port parity: the port's copy of the paged KV pool against the
reference's.

Contract: the same alloc / free / reclaim (and prefix-share / COW)
sequence gives the same page tables, free lists, refcounts and reports
in both pools — the module is numpy-only and copied, so any drift is a
fault in the copy.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve import kv_pool as jpool  # noqa: E402
from repro_torch.serve import kv_pool as tpool  # noqa: E402


def _state(pool):
    return (pool.table().tolist(), list(pool._free), dict(pool._ref),
            pool.report())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_sequence_same_tables_and_free_lists(seed):
    rng = np.random.default_rng(seed)
    args = (24, 4, 32, 4)        # n_pages, page_size, max_len, rows
    a, b = jpool.PagedKVPool(*args), tpool.PagedKVPool(*args)
    head = rng.integers(0, 50, 12).tolist()
    for _ in range(40):
        row = int(rng.integers(0, 4))
        if a.row_pages(row):
            assert a.free_row(row) == b.free_row(row)
        elif rng.random() < 0.5:
            need = int(rng.integers(1, 33))
            fits = a.can_alloc(need)
            assert b.can_alloc(need) == fits
            if fits:
                assert a.alloc(row, need) == b.alloc(row, need)
        else:
            toks = head[:int(rng.integers(4, 13))] + rng.integers(
                0, 50, 3).tolist()
            need = len(toks) + 2
            fits = a.can_alloc_shared(need, toks)
            assert b.can_alloc_shared(need, toks) == fits
            if fits:
                assert a.alloc_shared(row, need, toks) == b.alloc_shared(
                    row, need, toks)
                assert a.register_prefix(row, toks) == b.register_prefix(
                    row, toks)
        assert _state(a) == _state(b)
        assert b.conservation_ok()
    assert tpool.default_pool_pages(4, 32, 4) == jpool.default_pool_pages(
        4, 32, 4)
