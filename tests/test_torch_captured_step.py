"""The captured window step against the eager one, on the card.

Every test here is marked ``gpu`` and skips without CUDA (a CUDA graph
has no CPU mode); on a machine with a card run

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \\
        tests/test_torch_captured_step.py

This file imports neither JAX nor the reference package.

Contracts (docs/PORT.md): a ``BatchScheduler`` on the card captures each
lane's window step once, at its second step, and replays it after; its
logits equal the eager step's (``capture=False``) BITWISE at every step,
at float32 and bfloat16, paged and dense, with the CUDA kernels and with
their plain versions, so the greedy streams are identical.  A lane
captures once over any number of prompt mixes; replays read the page
tables and fill markers that admission and release write in place; and a
host sync inside the capture raises.  A hot-swap replays the graph
through its window with the live write leak in the step's leak buffer,
and the flip drops the graph and captures once more over the promoted
planes: two captures, no retrace, the eager streams, and an ``init``
swap serves the streams of no swap at all.  Two tenant lanes capture
once each and read their own planes (a dedicated scheduler's streams);
an in-place swap of B pauses B and captures it again while A's replayed
tokens stay those of no swap; an eviction of B on the executor beside
the scheduler drops B's graph and makes B's lane raise, and a redeploy
of B's checkpoint serves its streams; with B evicted, the scheduler's
step raises before A's lane runs, and the scheduler's redeploy of B
pauses B's lane until the flip while A serves on; ``set_weights`` adds
no capture.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.planes import write_leak_codes  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import BatchScheduler, Request  # noqa: E402
from repro_torch.serve.hotswap import finetune_delta  # noqa: E402

pytestmark = pytest.mark.gpu

MAX_NEW = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _model(dev, dtype=torch.float32, use_kernel=True, **xbar):
    cfg = get_config("qwen3-4b", smoke=True)
    cfg = dataclasses.replace(
        cfg, backend="crossbar", dtype=dtype, paged_kernel=use_kernel,
        xbar=dataclasses.replace(cfg.xbar, use_kernel=use_kernel, **xbar))
    return build_model(cfg, device=dev)


def _tapped(model, steps):
    """``model`` whose decode_step copies its logits into one static
    buffer (a copy a CUDA graph can hold); ``steps`` receives the buffer,
    read on the host after each scheduler step."""
    inner = model.decode_step
    buf = {}

    def decode_step(params, tokens, cache):
        logits, cache = inner(params, tokens, cache)
        if "logits" not in buf:
            buf["logits"] = torch.empty_like(logits)
        buf["logits"].copy_(logits)
        return logits, cache

    steps.append(buf)
    return dataclasses.replace(model, decode_step=decode_step)


def _mix(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 383, n).astype(np.int32) for n in lens]


def _run(sched, prompts, tap=None, stagger=0):
    """Serve ``prompts`` (the first ``stagger`` steps with only the first
    one submitted); returns the streams and, with ``tap``, each step's
    logits."""
    pending = [Request(rid=i, prompt=p, max_new=MAX_NEW)
               for i, p in enumerate(prompts)]
    sched.submit(pending.pop(0))
    done, logits, steps = [], [], 0
    while len(done) < len(prompts) and steps < 200:
        if steps >= stagger:
            while pending:
                sched.submit(pending.pop(0))
        done += sched.step()
        steps += 1
        if tap is not None:
            logits.append(tap[-1]["logits"].cpu())
    return {r.rid: list(r.out) for r in done}, logits


@pytest.mark.parametrize("dtype,kv,use_kernel", [
    (torch.float32, "paged", True), (torch.float32, "dense", True),
    (torch.bfloat16, "paged", True), (torch.bfloat16, "dense", True),
    (torch.float32, "paged", False)])
def test_captured_logits_equal_eager_bitwise(cuda, dtype, kv, use_kernel):
    prompts = _mix(0, (5, 11, 3))
    model = _model(cuda, dtype, use_kernel)
    params = model.init(0)
    out = {}
    for capture in (False, True):
        tap = []
        sched = BatchScheduler(_tapped(model, tap), params, n_slots=2,
                               max_len=32, kv=kv, capture=capture)
        out[capture] = _run(sched, prompts, tap)
        rep = sched.capture_report()["A"]
        assert rep["captures"] == int(capture)
        assert rep["replays"] == (len(out[capture][1]) - 1 if capture
                                  else 0)
    (s_eager, l_eager), (s_cap, l_cap) = out[False], out[True]
    assert s_cap == s_eager
    assert len(l_cap) == len(l_eager) > 2
    for a, b in zip(l_eager, l_cap):
        assert torch.equal(a, b)


def test_one_capture_per_lane_over_three_prompt_mixes(cuda):
    model = _model(cuda)
    params = model.init(0)
    sched = BatchScheduler(model, params, n_slots=2, max_len=32)
    eager = BatchScheduler(model, params, n_slots=2, max_len=32,
                           capture=False)
    reg = obs.registry()
    before = (reg.total("serve_jit_traces_total", closure="decode"),
              reg.total("serve_jit_retraces_total", closure="decode"))
    steps = 0
    for seed, lens in ((1, (5, 11, 3)), (2, (2, 17)), (3, (9, 1, 6, 4))):
        prompts = _mix(seed, lens)
        got, _ = _run(sched, prompts)
        want, _ = _run(eager, prompts)
        assert got == want
        rep = sched.capture_report()["A"]
        assert rep["captures"] == 1
        assert rep["replays"] + rep["eager_steps"] > steps
        steps = rep["replays"] + rep["eager_steps"]
    # one trace per scheduler's closure (the eager one's first call, the
    # captured one's capture), no retrace
    assert (reg.total("serve_jit_traces_total", closure="decode")
            - before[0]) == 2
    assert (reg.total("serve_jit_retraces_total", closure="decode")
            - before[1]) == 0


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_replays_see_admission_and_release(cuda, kv):
    # three requests on two slots, the last two submitted after the
    # capture: their page tables and fill markers are written in place
    # between replays, and the third takes a released slot
    prompts = _mix(4, (6, 3, 9))
    model = _model(cuda)
    params = model.init(0)
    runs = {}
    for capture in (False, True):
        sched = BatchScheduler(model, params, n_slots=2, max_len=32, kv=kv,
                               capture=capture)
        runs[capture], _ = _run(sched, prompts, stagger=3)
        layers = sched._lanes["A"].cache["layers"]
        if kv == "paged":
            assert int(layers["pt"].abs().sum()) == 0   # all released
        assert int(layers["len"].abs().sum()) == 0
    assert sched.capture_report()["A"]["captures"] == 1
    assert runs[True] == runs[False]


def test_a_host_sync_in_the_capture_raises(cuda):
    model = _model(cuda)
    params = model.init(0)
    inner = model.decode_step

    def syncing(params, tokens, cache):
        logits, cache = inner(params, tokens, cache)
        logits.sum().item()           # a host sync: illegal in a capture
        return logits, cache

    sched = BatchScheduler(dataclasses.replace(model, decode_step=syncing),
                           params, n_slots=2, max_len=32)
    for i, p in enumerate(_mix(5, (9, 7))):
        sched.submit(Request(rid=i, prompt=p, max_new=MAX_NEW))
    sched.step()                      # the eager warm-up syncs freely
    with pytest.raises(RuntimeError):
        sched.step()                  # the capture
    assert sched._lanes["A"].decode.graph is None
    torch.cuda.synchronize()


def _swap_run(sched, prompts, new_params, at_step=2, chunks=4):
    """Serve ``prompts`` with a hot-swap of ``new_params`` begun before
    step ``at_step``, until every request finished and the swap promoted:
    the streams, each step's snapshot of every request's tokens, each
    step's leak buffer and swap phase (window / flip / -)."""
    reqs = [Request(rid=i, prompt=p, max_new=2 * MAX_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    done, snaps, leaks, phase, steps = [], [], [], [], 0
    while (len(done) < len(reqs) or sched.swap_in_flight) and steps < 200:
        if new_params is not None and steps == at_step:
            sched.begin_hot_swap(new_params, chunks_per_step=chunks)
        was = sched.swap_in_flight
        done += sched.step()
        steps += 1
        snaps.append({r.rid: list(r.out) for r in reqs})
        leaks.append(sched._lanes["A"].decode.leak.item())
        phase.append("window" if sched.swap_in_flight
                     else "flip" if was else "-")
    return {r.rid: list(r.out) for r in done}, snaps, leaks, phase


def test_hot_swap_replays_its_window_and_captures_again_after_the_flip(
        cuda):
    prompts = _mix(6, (5, 11, 3))
    params = _model(cuda).init(0)
    new = finetune_delta(params, 0.05)
    reg = obs.registry()
    runs = {}
    for capture in (True, False):
        model = _model(cuda, swap_leakage=True)   # a fresh executor each
        leak = float(np.float32(write_leak_codes(model.executor.cfg)))
        before = (reg.total("serve_jit_traces_total", closure="decode"),
                  reg.total("serve_jit_retraces_total", closure="decode"))
        sched = BatchScheduler(model, params, n_slots=2, max_len=64,
                               capture=capture)
        runs[capture] = _swap_run(sched, prompts, new)
        rep = sched.capture_report()["A"]
        assert rep["captures"] == (2 if capture else 0)
        assert (reg.total("serve_jit_traces_total", closure="decode")
                - before[0]) == 2
        assert (reg.total("serve_jit_retraces_total", closure="decode")
                - before[1]) == 0
        (hist,) = sched.swap_history
        assert hist["policy"] == "overlapped" and model.executor.version() == 2
        streams, _, leaks, phase = runs[capture]
        assert all(len(s) == 2 * MAX_NEW for s in streams.values())
        flip = phase.index("flip")
        assert phase[2:flip] == ["window"] * (flip - 2) and flip - 2 >= 3
        assert hist["decode_steps_during_swap"] == flip - 2
        assert len(phase) - flip >= 4        # a capture, then replays
        assert leaks[2:flip] == [leak] * (flip - 2)
        assert set(leaks[:2] + leaks[flip:]) == {0.0}
    assert runs[True][0] == runs[False][0]
    # the window reads the old planes (its leak rounds away): every token
    # before the flip is that of a serve without a swap
    _, plain_snaps, _, _ = _swap_run(
        BatchScheduler(_model(cuda), params, n_slots=2, max_len=64),
        prompts, None)
    flip = runs[True][3].index("flip")
    assert runs[True][1][:flip] == plain_snaps[:flip]
    assert runs[True][1][flip:] != plain_snaps[flip:]


def test_an_init_swap_serves_the_streams_of_no_swap(cuda):
    prompts = _mix(7, (9, 4, 6))
    model = _model(cuda)
    params = model.init(0)
    plain, _, _, _ = _swap_run(
        BatchScheduler(model, params, n_slots=2, max_len=64), prompts, None)
    sched = BatchScheduler(model, params, n_slots=2, max_len=64)
    swapped, _, _, phase = _swap_run(sched, prompts, params)
    assert "flip" in phase and sched._lanes["A"].params is params
    assert sched.capture_report()["A"]["captures"] == 2
    assert swapped == plain


# -- two tenant lanes: one graph each, following each tenant's planes -------

def _mux(model, params_a, params_b, capture=True):
    return BatchScheduler(model, params_a, n_slots=2, max_len=64,
                          tenants={"A": (params_a, 2.0),
                                   "B": (params_b, 1.0)},
                          kv_pages=14, capture=capture)


def _mux_run(sched, prompts, event=None, at_step=3):
    """Serve ``prompts`` round-robin over A and B; ``event(sched)`` runs
    before step ``at_step`` (and the loop steps on while a swap is in
    flight).  The streams, and after every step a snapshot of tenant A's
    tokens."""
    reqs = [Request(rid=i, prompt=p, max_new=2 * MAX_NEW,
                    model_id="AB"[i % 2]) for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    done, snaps, steps = [], [], 0
    while (len(done) < len(reqs) or sched.swap_in_flight) and steps < 200:
        if event is not None and steps == at_step:
            event(sched)
        done += sched.step()
        steps += 1
        snaps.append({r.rid: list(r.out) for r in reqs if r.model_id == "A"})
    return {r.rid: list(r.out) for r in done}, snaps


def _traces(reg):
    return (reg.total("serve_jit_traces_total", closure="decode"),
            reg.total("serve_jit_retraces_total", closure="decode"))


def test_two_lanes_capture_once_and_read_their_own_planes(cuda):
    prompts = _mix(8, (5, 9, 3, 7, 6))
    model = _model(cuda)
    params_a, params_b = model.init(0), model.init(1)
    reg = obs.registry()
    before = _traces(reg)
    sched = _mux(model, params_a, params_b)
    got, _ = _mux_run(sched, prompts)
    rep = sched.capture_report()
    assert {t: rep[t]["captures"] for t in "AB"} == {"A": 1, "B": 1}
    assert all(rep[t]["replays"] > 0 for t in "AB")
    after = _traces(reg)
    assert (after[0] - before[0], after[1] - before[1]) == (2, 0)
    eager, _ = _mux_run(_mux(model, params_a, params_b, capture=False),
                        prompts)
    assert got == eager
    # each lane replays its own tenant's planes: its streams are those of
    # a dedicated scheduler of that checkpoint
    for t, params in (("A", params_a), ("B", params_b)):
        ded = BatchScheduler(_model(cuda), params, n_slots=2, max_len=64)
        mine = [i for i in range(len(prompts)) if "AB"[i % 2] == t]
        reqs = [Request(rid=i, prompt=prompts[i], max_new=2 * MAX_NEW)
                for i in mine]
        for r in reqs:
            ded.submit(r)
        done = []
        while len(done) < len(reqs):
            done += ded.step()
        assert {r.rid: list(r.out) for r in done} == {
            i: got[i] for i in mine}, t


def test_in_place_swap_pauses_b_and_captures_it_again(cuda):
    prompts = _mix(9, (6, 8, 4, 5))
    model = _model(cuda)
    params_a, params_b = model.init(0), model.init(1)
    plain, plain_snaps = _mux_run(_mux(model, params_a, params_b), prompts)
    sched = _mux(model, params_a, params_b)
    reg = obs.registry()
    before = _traces(reg)
    swapped, snaps = _mux_run(sched, prompts, lambda s: s.begin_hot_swap(
        params_b, chunks_per_step=4, tenant="B"))
    (hist,) = sched.swap_history
    assert (hist["tenant"], hist["swap_mode"]) == ("B", "in_place")
    assert hist["decode_steps_during_swap"] >= 3
    assert not sched._lanes["B"].paused
    assert model.executor.version("B") == 2
    rep = sched.capture_report()
    assert {t: rep[t]["captures"] for t in "AB"} == {"A": 1, "B": 2}
    after = _traces(reg)
    assert (after[0] - before[0], after[1] - before[1]) == (3, 0)
    # A's replays through B's pause and B's capture again: every token
    # of A at every step is that of the serve without a swap, and B's
    # own checkpoint swapped in gives B's streams
    assert snaps[:len(plain_snaps)] == plain_snaps
    assert swapped == plain


def test_eviction_beside_the_scheduler_drops_b_and_redeploy_serves(cuda):
    prompts = _mix(10, (4, 6, 5, 3))
    model = _model(cuda)
    ex = model.executor
    params_a, params_b = model.init(0), model.init(1)
    plain, _ = _mux_run(_mux(model, params_a, params_b), prompts)
    sched = _mux(model, params_a, params_b)
    lanes = sched._lanes

    def evict(s):
        step = lanes["B"].decode
        assert step.graph is not None                 # B has captured
        ex.evict_tenant("B")
        # B's next step (called as the scheduler calls it) raises, and
        # drops the graph, instead of replaying freed planes
        idle = (np.zeros(tuple(step.tokens.shape), np.int32),
                np.zeros(tuple(step.m.shape), np.int32))
        for _ in range(2):
            with pytest.raises(RuntimeError, match="'B' is not resident"):
                step(lanes["B"].params, *idle, None)
            assert step.graph is None
        ex.swap(lanes["B"].params, tenant="B")      # the live redeploy

    got, _ = _mux_run(sched, prompts, evict, at_step=6)
    assert got == plain
    rep = sched.capture_report()
    assert {t: rep[t]["captures"] for t in "AB"} == {"A": 1, "B": 2}
    assert ex.version("B") == 2 and ex.plane_generation("A") == 1


def test_a_step_with_b_evicted_raises_before_a_runs(cuda):
    prompts = _mix(12, (5, 4, 6, 3))
    model = _model(cuda)
    ex = model.executor
    params_a, params_b = model.init(0), model.init(1)
    plain, plain_snaps = _mux_run(_mux(model, params_a, params_b), prompts)
    sched = _mux(model, params_a, params_b)
    lanes = sched._lanes

    def outs():
        return {r.rid: list(r.out) for lane in lanes.values()
                for r in lane.slots if r is not None}

    def evict(s):
        assert lanes["B"].decode.graph is not None    # B has captured
        ex.evict_tenant("B")
        before = outs()
        with pytest.raises(RuntimeError, match="'B' is not resident"):
            s.step()
        # the step raised before A's lane ran, and dropped B's graph
        assert outs() == before and lanes["B"].decode.graph is None
        # the scheduler deploys B back: B's lane pauses until the flip
        s.begin_hot_swap(params_b, chunks_per_step=4, tenant="B")
        assert lanes["B"].paused

    got, snaps = _mux_run(sched, prompts, evict, at_step=6)
    assert got == plain
    assert snaps[:len(plain_snaps)] == plain_snaps
    assert sched.swap_history[-1]["swap_mode"] == "staged"
    rep = sched.capture_report()
    assert {t: rep[t]["captures"] for t in "AB"} == {"A": 1, "B": 2}
    assert ex.version("B") == 2 and ex.plane_generation("A") == 1


def test_set_weights_adds_no_capture(cuda):
    prompts = _mix(11, (5, 7, 6, 4))
    model = _model(cuda)
    params_a, params_b = model.init(0), model.init(1)
    plain, _ = _mux_run(_mux(model, params_a, params_b), prompts)
    sched = _mux(model, params_a, params_b)
    reg = obs.registry()
    before = _traces(reg)
    got, _ = _mux_run(sched, prompts,
                      lambda s: s.set_weights({"A": 1.0, "B": 3.0}))
    assert got == plain
    rep = sched.capture_report()
    assert {t: rep[t]["captures"] for t in "AB"} == {"A": 1, "B": 1}
    after = _traces(reg)
    assert (after[0] - before[0], after[1] - before[1]) == (2, 0)
    assert sched.qos_report()["B"]["weight"] == 3.0
