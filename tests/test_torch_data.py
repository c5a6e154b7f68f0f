"""Port parity: the synthetic token pipeline (``data/pipeline.py``).

Contract (docs/PORT.md, "Training and fault tolerance"):
* ``SyntheticLM.perm`` equals the reference's bit for bit (both draw it
  from ``np.random.default_rng(seed).permutation``);
* a batch keeps the reference's contract, not its bits (``jax.random``
  cannot be replayed in torch): a pure function of (seed, step), int32
  ``tokens`` and ``labels`` of shape (global_batch, seq_len - 1) with
  the labels the tokens shifted by one, the marker 0 at every
  ``period``-th position of the stream, every other position either the
  permutation's successor of the one before or a noise token, at the
  reference's noise rate;
* ``host_shard_at`` partitions the global batch by host id.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs one worker process per core

import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jdata  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402

CFG = dict(vocab=384, seq_len=65, global_batch=8, seed=3)


def _stream(batch):
    """The (B, seq_len) token stream a batch was cut from."""
    return torch.cat([batch["tokens"][:, :1], batch["labels"]], dim=1)


@pytest.mark.parametrize("seed", [0, 3])
def test_perm_equals_the_reference(seed):
    cfg = dict(CFG, seed=seed)
    want = jdata.SyntheticLM(jdata.DataConfig(**cfg)).perm
    got = tdata.SyntheticLM(tdata.DataConfig(**cfg), device="cpu").perm
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.asarray(want).dtype == jnp.int32


def test_batches_keep_the_reference_contract():
    data = tdata.SyntheticLM(tdata.DataConfig(**CFG), device="cpu")
    ref = jdata.SyntheticLM(jdata.DataConfig(**CFG)).batch_at(0)
    b0 = data.batch_at(0)
    for key in ("tokens", "labels"):
        assert b0[key].dtype == torch.int32
        assert tuple(b0[key].shape) == tuple(ref[key].shape)
    assert torch.equal(b0["tokens"][:, 1:], b0["labels"][:, :-1])
    # a pure function of (seed, step): a second pipeline, any order
    again = tdata.SyntheticLM(tdata.DataConfig(**CFG), device="cpu")
    assert torch.equal(again.batch_at(5)["tokens"],
                       data.batch_at(5)["tokens"])
    assert torch.equal(again.batch_at(0)["labels"], b0["labels"])
    assert not torch.equal(data.batch_at(1)["tokens"], b0["tokens"])
    other = tdata.SyntheticLM(tdata.DataConfig(**dict(CFG, seed=4)),
                              device="cpu")
    assert not torch.equal(other.batch_at(0)["tokens"], b0["tokens"])
    # markers every period, the chain through perm elsewhere, noise at
    # the configured rate (here over 64 batches, 33,280 draws)
    perm = data.perm.to(torch.int64)
    period = data.cfg.period
    follows = noisy = 0
    for step in range(64):
        seq = _stream(data.batch_at(step)).to(torch.int64)
        pos = torch.arange(seq.shape[1])
        assert (seq[:, pos % period == 0] == 0).all()
        assert ((seq >= 0) & (seq < CFG["vocab"])).all()
        free = pos[(pos % period > 1)]        # neither it nor its
        # predecessor a marker
        hit = seq[:, free] == perm[seq[:, free - 1]]
        follows += int(hit.sum())
        noisy += int((~hit).sum())
    # a noisy position breaks the chain at itself and at its successor,
    # so about 1 - (1 - noise)^2 of the positions miss
    rate = noisy / (follows + noisy)
    assert 0.16 < rate < 0.22, rate
    # the reference's batches, same test: the same rate
    ref_noisy = ref_total = 0
    jd = jdata.SyntheticLM(jdata.DataConfig(**CFG))
    jperm = np.asarray(jd.perm)
    for step in range(16):
        jb = jd.batch_at(step)
        seq = np.concatenate([np.asarray(jb["tokens"])[:, :1],
                              np.asarray(jb["labels"])], axis=1)
        free = np.arange(seq.shape[1])
        free = free[free % period > 1]
        hit = seq[:, free] == jperm[seq[:, free - 1]]
        ref_noisy += int((~hit).sum())
        ref_total += hit.size
    assert abs(ref_noisy / ref_total - rate) < 0.03


def test_host_shard_partitions_the_batch():
    data = tdata.SyntheticLM(tdata.DataConfig(**CFG), device="cpu")
    full = data.batch_at(7)
    shards = [data.host_shard_at(7, h, 4) for h in range(4)]
    for key in ("tokens", "labels"):
        assert all(s[key].shape[0] == CFG["global_batch"] // 4
                   for s in shards)
        assert torch.equal(torch.cat([s[key] for s in shards]), full[key])


def test_the_pipeline_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdata.SyntheticLM(tdata.DataConfig(**CFG))
