"""Train CLI: ``python -m repro_torch.launch.train --arch qwen3-4b
--smoke --steps 50 --ckpt-dir <dir>``.

Wires the layers together as the reference's ``launch/train.py`` does:
config registry -> model -> deterministic data pipeline -> train step ->
async checkpointing -> preemption handling -> auto-resume.  It runs on the
card unless ``--device cpu`` is given; ``--layers N`` cuts the
configuration's depth.  Only the local (one-device) mesh exists: the
pod meshes come with the port's distribution slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import ft
from repro_torch.models.model import build_model
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer


def main(argv=None, record=None):
    """Run the CLI on ``argv``; returns the final ``TrainState``.
    ``record`` (a keyword, no flag) is a list that receives one dict per
    step: its loss, grad norm and lr as floats and its wall seconds,
    the device synchronised at both ends."""
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

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family in ("encdec", "vlm"):
        raise SystemExit("train driver covers LM families; see examples/")
    if args.mesh != "local":
        raise SystemExit(f"--mesh {args.mesh}: the pod meshes need the "
                         f"port's distribution layer (ROADMAP.md, A.12); "
                         f"only --mesh local runs")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg, device=args.device)

    opt_cfg = opt.AdamWConfig(lr=args.lr, warmup_steps=10,
                              total_steps=args.steps)
    step_fn = trainer.make_train_step(model, opt_cfg,
                                      microbatches=args.microbatches,
                                      donate=True)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len + 1,
                                  global_batch=args.batch),
                       device=model.device)

    mgr = (CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir
           else None)
    handler = ft.PreemptionHandler()

    def init():
        return trainer.init_state(model, 0)

    if mgr is not None:
        state, start = ft.restore_or_init(mgr, init)
        if start:
            print(f"[resume] from step {start}")
    else:
        state, start = init(), 0

    t0 = time.time()
    try:
        for step in range(start, args.steps):
            batch = data.batch_at(step)
            t_step = time.perf_counter()
            state, metrics = step_fn(state, batch)
            if record is not None:
                row = {k: float(metrics[k])
                       for k in ("loss", "grad_norm", "lr")}
                row.update(step=step, s=time.perf_counter() - t_step)
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
                mgr.save(step + 1, state)
                if handler.requested:
                    print(f"[preempt] checkpoint at step {step + 1}; bye")
                    mgr.wait()
                    return state
        if mgr is not None:
            mgr.wait()
    finally:
        handler.restore()
    print("done.")
    return state


if __name__ == "__main__":
    main()
