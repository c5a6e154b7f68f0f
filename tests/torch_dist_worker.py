"""One rank of the four-rank gloo world that ``test_torch_dist.py``
spawns: a (2, 2) ("data", "model") mesh over a FileStore.  It imports
only torch and the port; the reference's values reach it (and its
results leave it) through ``.npz`` files in the test's directory.

    python tests/torch_dist_worker.py <rank> <world> <store> <dir>
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def main(rank: int, world: int, store: str, io: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.train import place
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    d_i, m_i = mesh.get_coordinate()
    inp = np.load(io / "inputs.npz")
    out = {"coord": np.array([d_i, m_i])}

    # compressed_psum over "data": rank (d, m) holds gradient d
    mean, err = opt.compressed_psum(torch.from_numpy(inp["g"][d_i]),
                                    mesh.get_group("data"),
                                    torch.from_numpy(inp["err"][d_i]))
    out["psum_mean"], out["psum_err"] = mean.numpy(), err.numpy()

    # tp_bf16_matmul: the contraction split over "model"
    rules = shd.ShardingRules(rules=dict(shd.fsdp_rules().rules,
                                         _tp_bf16_reduce=True))
    h = torch.from_numpy(inp["h"]).to(torch.bfloat16)
    w = torch.from_numpy(inp["w"]).to(torch.bfloat16)
    with shd.use_rules(rules, mesh):
        y = shd.tp_bf16_matmul(h, w)
    out["tp_y"] = y.to(torch.float32).numpy()

    # the reference's checkpoint restored onto the mesh
    cfg = get_config("qwen3-4b", smoke=True)
    model = build_model(cfg, device="cpu")
    fsdp = shd.fsdp_rules()
    got = CheckpointManager(str(io / "ref_ckpt")).restore(
        model.init(0), shardings=shd.sharding_tree(model.param_specs(), fsdp,
                                                   mesh))
    for key, leaf in tree.leaves_with_keys(got):
        out["restore/" + key] = leaf.to_local().numpy()

    # the train step under fsdp_rules against the single-process step,
    # float32 throughout (activations too)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    opt_cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=3)
    step = trainer.make_train_step(model, opt_cfg,
                                   compute_dtype=torch.float32)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=17,
                                  global_batch=4), device=model.device)
    specs = trainer.state_specs(model)
    batch_specs = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    plain = trainer.init_state(model, 0)
    state = place(trainer.init_state(model, 0), specs, fsdp, mesh)
    losses, sharded = [], []
    for i in range(3):
        batch = data.batch_at(i)
        plain, m = step(plain, batch)
        losses.append(float(m["loss"]))
        with shd.use_rules(fsdp, mesh):
            state, m = step(state, place(batch, batch_specs, fsdp, mesh))
            sharded.append(float(m["loss"].full_tensor()))
    out["loss_plain"], out["loss_sharded"] = np.array(losses), np.array(
        sharded)
    placements = []
    for (key, a), b in zip(tree.leaves_with_keys(state.params),
                           tree.leaves(plain.params)):
        whole = a.full_tensor()
        placements.append(f"{key}={a.placements}")
        out["param_sharded/" + key] = whole.numpy()
        out["param_plain/" + key] = b.numpy()
    out["placements"] = np.array(placements)
    np.savez(io / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4]))
