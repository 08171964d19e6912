"""One rank of the CPU multi-rank tests (test_torch_parallel.py,
test_torch_tp.py; this module holds no tests of its own), started by
arnerf_tpu_torch.parallel.launch with torchrun's environment:

    python tests/test_torch_parallel_worker.py <spec.json>

`run_ranks` starts them from a test. The spec's `n_dp` x `n_mp` gloo
ranks build the port's trainer at tests/test_tp.py's size and, for
`"kind": "blocks"`, train `blocks` training blocks (after loading `load`,
if given, and saving to `save` after), or, for `"kind": "step"`, take one
joined step on the explicit rays and draws of `inputs` (an .npz the test
writes). Each rank writes what it holds to `<out>/rank<r>.npz`. Imports
no JAX.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from arnerf_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                 SyntheticDataset)
from arnerf_tpu_torch.models import NGPConfig, grid_state_init
from arnerf_tpu_torch.parallel import init_distributed, make_mesh_2d
from arnerf_tpu_torch.parallel.accounting import block_collective_report
from arnerf_tpu_torch.parallel.launch import launch
from arnerf_tpu_torch.training import trainer as t_trainer
from arnerf_tpu_torch.training.ckpt import params_from_jax, tree_leaves
from arnerf_tpu_torch.training.losses import NeRFLossConfig

TIMEOUT = 240          # seconds for every rank of one run to finish
SMALL = dict(scale=0.5, grid_size=32, n_levels=4, log2_hashmap_size=12,
             base_resolution=4)


def port_setup():
    """tests/test_tp.py's _setup for the port."""
    ds = SyntheticDataset(split="train", config=SyntheticConfig(
        img_wh=(16, 16), n_train=3, n_test=1, gt_samples=32))
    tc = t_trainer.TrainConfig(batch_size=64, num_epochs=1,
                               steps_per_epoch=10, warmup_steps=0,
                               samples_per_ray_budget=16,
                               adaptive_budget=False,
                               loss=NeRFLossConfig(grid_scale=0.5))
    return NGPConfig(**SMALL), tc, ds


def _numpy(x):
    return x.detach().numpy().copy() if torch.is_tensor(x) else np.array(x)


def blocks(spec, mesh):
    cfg, tc, ds = port_setup()
    tr = t_trainer.NeRFTrainer(cfg, tc, ds, mesh=mesh,
                               shard_table=spec.get("shard_table"))
    out = {}
    if spec.get("load"):
        tr.load(spec["load"])
        out["loaded_table"] = _numpy(tr.params["hash_table"])
        out["loaded_step"] = tr.step
    tr.on_train_start()
    for b in range(spec["blocks"]):
        m = tr.train_block()
        for k, v in m.items():
            out[f"metric{b}/{k}"] = float(v)
    if spec.get("save"):
        tr.save(spec["save"])
    for i, leaf in enumerate(tree_leaves(tr.params)):
        out[f"param/{i}"] = _numpy(leaf)
    for i, leaf in enumerate(tr.opt.state_leaves()):
        out[f"opt/{i}"] = _numpy(leaf)
    for k, v in tr.grid_state._asdict().items():
        out[f"grid/{k}"] = _numpy(v)
    report = block_collective_report(tr)
    for k, v in report["per_block"].items():
        out[f"collective/{k}"] = v
    out["total_step_bytes"] = report["total_step_bytes"]
    return out


class RecordingAdam(t_trainer.Adam):
    """Adam that keeps the (joined) gradients it was given."""

    def step(self, params, grads):
        self.seen = [g.detach().clone() for g in grads]
        super().step(params, grads)


def step(spec, mesh):
    """One joined step (step_loss on this rank's explicit inputs, then
    finish_step over the mesh), as tests/test_torch_train.py:81 feeds both
    packages."""
    with np.load(spec["inputs"]) as f:
        data = dict(f)
    r = mesh.rank
    cfg = NGPConfig(fused_head=True, **SMALL)
    params = params_from_jax(data)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    state = grid_state_init(cfg)._replace(
        occ_flat=torch.from_numpy(data["occ"]))
    B = data[f"ro/{r}"].shape[0]
    tc = t_trainer.TrainConfig(batch_size=B, lr=1e-2, num_epochs=2,
                               steps_per_epoch=100, seg_cap=8,
                               samples_per_ray_budget=32)
    opt = RecordingAdam(params, t_trainer.make_optimizer(tc, params)[1])
    t = {k: torch.from_numpy(data[f"{k}/{r}"])
         for k in ("ro", "rd", "gt", "noise")}
    loss, res = t_trainer.step_loss(
        params, state, t["ro"], t["rd"], t["gt"], noise=t["noise"],
        seed=None, rgb_bg=None, cfg=cfg, tc=tc, exp_step_factor=0.0,
        seg_cap=8)
    metrics = t_trainer.finish_step(params, opt, loss, res, t["gt"], tc=tc,
                                    mesh=mesh)
    out = {"local_loss": float(loss)}
    out.update({f"metric/{k}": float(v) for k, v in metrics.items()})
    out.update({f"grad/{i}": _numpy(g) for i, g in enumerate(opt.seen)})
    out.update({f"param/{i}": _numpy(p)
                for i, p in enumerate(tree_leaves(params))})
    return out


def run_ranks(specs, tmp):
    """Run each spec's ranks, all specs at once; returns, per spec, the
    list of its ranks' outputs (dicts of arrays)."""
    from concurrent.futures import ThreadPoolExecutor
    env = dict(os.environ, OMP_NUM_THREADS="1")
    paths = []
    for i, spec in enumerate(specs):
        out = Path(tmp) / f"run{i}"
        out.mkdir(parents=True)
        path = out / "spec.json"
        path.write_text(json.dumps({**spec, "out": str(out)}))
        paths.append(path)
    with ThreadPoolExecutor(len(specs)) as pool:
        futures = [pool.submit(launch, [__file__, str(p)],
                               s["n_dp"] * s["n_mp"], cpu=True,
                               timeout=TIMEOUT, env=env)
                   for s, p in zip(specs, paths)]
        for f in futures:
            f.result()
    results = []
    for s, p in zip(specs, paths):
        ranks = []
        for r in range(s["n_dp"] * s["n_mp"]):
            with np.load(p.parent / f"rank{r}.npz") as f:
                ranks.append(dict(f))
        results.append(ranks)
    return results


def main(spec_path):
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    init_distributed(torch.device("cpu"))
    mesh = make_mesh_2d(spec["n_dp"], spec["n_mp"])
    out = {"blocks": blocks, "step": step}[spec["kind"]](spec, mesh)
    np.savez(os.path.join(spec["out"], f"rank{mesh.rank}.npz"), **out)
    mesh.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
