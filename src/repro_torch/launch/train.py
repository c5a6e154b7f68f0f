"""Train CLI: ``python -m repro_torch.launch.train --arch qwen3-4b
--smoke --steps 50 --ckpt-dir <dir>``.

Wires the layers together as the reference's ``launch/train.py`` does:
config registry -> model -> deterministic data pipeline -> train step ->
async checkpointing -> preemption handling -> auto-resume.  It runs on the
card unless ``--device cpu`` is given; ``--layers N`` cuts the
configuration's depth.

``--mesh local`` (the default) runs on a 1-D ``"data"`` mesh of every
rank (one rank, NCCL on the card or gloo on the CPU, when started
without ``torchrun``) under the rules ``{"batch": "data"}``: the state
replicated, the batch split over the ranks (one rank splits nothing,
and its tensors stay plain).  ``--mesh pod|multipod``
runs on the 16 x 16 or 2 x 16 x 16 production mesh under
``fsdp_rules``; it needs a ``torchrun`` world of 256 or 512 ranks and
raises otherwise.  The state and each batch are DTensors placed by
their logical axes (``trainer.state_specs``).

On the card the donated train step is captured
(``trainer.GraphTrainStep``): one CUDA graph over the state that
``restore_or_init`` returns, replayed each step after the warm-up and
the capture.  A mesh of more than one rank runs the step eagerly (its
collectives are not captured).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import sharding as shd
from repro_torch.graphs import resolve_capture
from repro_torch.launch import ft
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer


def _start_world(device) -> bool:
    """Join the ``torchrun`` world its environment describes, if any and
    not joined yet.  True when this call started the group."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    if device == "cpu":
        dist.init_process_group("gloo")
    else:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    return True


def place(tree_, specs, rules, mesh):
    """Every tensor of ``tree_`` as a DTensor on ``mesh`` at its logical
    axes' placements; each rank holds the whole tensor and keeps its own
    shard (no communication).  A one-rank mesh splits nothing, so there
    the tensors stay plain: DTensor would add only its dispatch (on the
    card, a full-width step of 674 ms against 278-343 plain)."""
    if mesh.size() == 1:
        return tree_
    return shd.map_specs(
        lambda names, x: distribute_tensor(
            x, mesh, rules.placements(mesh, names), src_data_rank=None),
        specs, tree_)


def main(argv=None, record=None, capture=None):
    """Run the CLI on ``argv``; returns the final ``TrainState``.
    ``record`` (a keyword, no flag) is a list that receives one dict per
    step: its loss, grad norm and lr as floats and its wall seconds,
    the device synchronised at both ends (the read of the metrics), and
    for a captured step its captures, replays and eager steps so far.
    ``capture`` (a keyword, no flag: the reference's CLI has none):
    ``None`` captures the step on the card at one rank and runs it
    eagerly elsewhere; ``False`` is the eager witness; ``True`` raises
    without CUDA or on a mesh of more than one rank."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mesh", choices=["local", "pod", "multipod"],
                    default="local")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to its first N layers (0: all)")
    args = ap.parse_args(argv)

    resolve_capture(capture, torch.device(args.device or "cuda"))
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit("train driver covers LM families; see examples/")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    started = _start_world(args.device)
    owned = not dist.is_initialized()   # a one-rank group of our own
    try:
        return _run(args, cfg, record, capture)
    finally:
        if (started or owned) and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, cfg, record, capture):
    if args.mesh == "local":
        mesh = make_local_mesh(args.device)
        rules = shd.ShardingRules(rules={"batch": "data"})
    else:
        mesh = make_production_mesh(multi_pod=(args.mesh == "multipod"))
        rules = shd.fsdp_rules(multi_pod=(args.mesh == "multipod"))
    device = args.device
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    model = build_model(cfg, device=device)

    if mesh.size() > 1:
        if capture:
            raise ValueError(
                f"capture=True on a mesh of {mesh.size()} ranks: the "
                f"step's collectives are not captured; pass capture=None "
                f"or False")
        capture = False
    opt_cfg = opt.AdamWConfig(lr=args.lr, warmup_steps=10,
                              total_steps=args.steps)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len + 1,
                                  global_batch=args.batch),
                       device=model.device)
    state_specs = trainer.state_specs(model)
    batch_specs = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}

    mgr = (CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir
           else None)
    handler = ft.PreemptionHandler()

    def init():
        return place(trainer.init_state(model, 0), state_specs, rules, mesh)

    if mgr is not None:
        state, start = ft.restore_or_init(mgr, init)
        if start:
            state = place(state, state_specs, rules, mesh)
            print(f"[resume] from step {start}")
    else:
        state, start = init(), 0
    # the captured step binds the state its first call gets: this one
    step_fn = trainer.make_train_step(model, opt_cfg,
                                      microbatches=args.microbatches,
                                      donate=True, capture=capture)

    t0 = time.time()
    try:
        with shd.use_rules(rules, mesh):
            state, done = _loop(args, state, start, step_fn, data,
                                batch_specs, rules, mesh, mgr, handler,
                                record, t0)
    finally:
        handler.restore()
        if isinstance(step_fn, trainer.GraphTrainStep):
            step_fn.reset()
    if done:
        print("done.")
    return tree.map(_whole, state)


def _whole(t):
    """A DTensor leaf gathered whole (a plain tensor)."""
    return t.full_tensor() if isinstance(t, shd.DTensor) else t


def _loop(args, state, start, step_fn, data, batch_specs, rules, mesh,
          mgr, handler, record, t0):
    for step in range(start, args.steps):
        batch = data.batch_at(step)
        batch = place(batch, {k: batch_specs[k] for k in batch}, rules, mesh)
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics = {k: _whole(v) for k, v in metrics.items()}
        if record is not None:
            row = {k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")}
            row.update(step=step, s=time.perf_counter() - t_step)
            if isinstance(step_fn, trainer.GraphTrainStep):
                row.update(step_fn.stats)
            record.append(row)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics.get('lr', 0)):.2e} "
                  f"gnorm {float(metrics.get('grad_norm', 0)):.2f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if mgr is not None and (
                (step + 1) % args.ckpt_every == 0 or handler.requested
                or step == args.steps - 1):
            # a synchronous copy to the host, so the next replay cannot
            # overwrite the state before it is read
            mgr.save(step + 1, state)
            if handler.requested:
                print(f"[preempt] checkpoint at step {step + 1}; bye")
                mgr.wait()
                return state, False
    if mgr is not None:
        mgr.wait()
    return state, True


if __name__ == "__main__":
    main()
