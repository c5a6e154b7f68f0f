"""End-to-end training on the PyTorch port: a qwen3-family LM on the
synthetic pipeline with checkpoint/resume.  ~20M params by default;
``--d-model 768 --layers 12`` gives the ~100M variant (same code path).

Run on the card (the default) or on the CPU:

    PYTHONPATH=src python examples/torch_train_lm.py --steps 120 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import ft
from repro_torch.models.model import ModelConfig, build_model
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = ModelConfig(
        name="train-lm", family="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=args.d_model // 64, n_kv=2,
        head_dim=64, d_ff=4 * args.d_model, vocab=args.vocab,
        act="swiglu", qk_norm=True)
    model = build_model(cfg, device=args.device)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq + 1,
                                  global_batch=args.batch),
                       device=model.device)
    opt_cfg = opt.AdamWConfig(lr=3e-3, warmup_steps=20,
                              total_steps=args.steps)
    step_fn = trainer.make_train_step(model, opt_cfg, donate=True)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    state, start = ft.restore_or_init(
        mgr, lambda: trainer.init_state(model, 0))
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    print(f"model: {n_params/1e6:.1f}M params")
    if start:
        print(f"[resume] from step {start}")

    t0, first_loss, last_loss = time.time(), None, None
    for step in range(start, args.steps):
        state, metrics = step_fn(state, data.batch_at(step))
        loss = float(metrics["loss"])
        first_loss = first_loss if first_loss is not None else loss
        last_loss = loss
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if (step + 1) % 50 == 0:
            mgr.save(step + 1, state)
    mgr.save(args.steps, state, blocking=True)
    if first_loss is None:
        print(f"nothing to train: the checkpoint is at step {start}")
        return None, None
    print(f"loss: {first_loss:.3f} -> {last_loss:.3f} "
          f"({'improved' if last_loss < first_loss else 'NO IMPROVEMENT'})")
    return first_loss, last_loss


if __name__ == "__main__":
    main()
