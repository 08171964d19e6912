"""Data-parallel gradient and metric join (port of arnerf_tpu/parallel/dp.py).

Semantics of the reference's multi-GPU training (DDP, reference
train.py:286-291) as the JAX package keeps them: every rank draws its own
`batch_size` rays from its own generator, so N ranks train on N x the
rays; gradients are joined as a mean over all ranks before Adam, so
parameters and Adam state stay identical on every rank; metrics are
joined as a mean, except the segment demand `nseg`, which takes the max
(the truncation guard of the adaptive segment pool).

The port's trainer is a dict of tensors with a hand Adam
(training/trainer.py), not an nn.Module, so it takes the explicit
all-reduce that DistributedDataParallel performs, not a DDP wrapper: the
gradient leaves and the mean metrics go into one float32 buffer, summed by
one all-reduce and divided by the rank count, as lax.pmean does.
"""

import torch
import torch.distributed as dist

from .accounting import count

MEAN_METRICS = ("loss", "psnr", "rm_s", "vr_s", "nseg_avg")


def all_reduce(tensor, mesh, group, op="sum"):
    """In-place all-reduce over `group`, counted as psum (sum) or pmax."""
    count(mesh, "pmax" if op == "max" else "psum", tensor)
    dist.all_reduce(tensor, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return tensor


def join_step(leaves, grads, metrics: dict, mesh, tp=None):
    """One step's join across `mesh`: (grads, metrics) -> their means over
    every rank (nseg: the max). `grads` align with `leaves` (None counts
    as zero). With `tp` (parallel/tp.py) the table's gradient arrives as
    this rank's shard, already summed over the model group; tp.join_table
    finishes it, and every other leaf is meaned over all ranks."""
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    table = None if tp is None else tp.leaf_index(leaves)
    rest = [i for i in range(len(grads)) if i != table]
    keys = [k for k in MEAN_METRICS if k in metrics]
    flat = torch.cat([grads[i].reshape(-1).float() for i in rest]
                     + [torch.stack([metrics[k].float().reshape(())
                                     for k in keys])])
    all_reduce(flat, mesh, mesh.world).div_(mesh.size)
    joined = list(grads)
    offset = 0
    for i in rest:
        n = grads[i].numel()
        joined[i] = flat[offset:offset + n].view_as(grads[i]).to(
            grads[i].dtype)
        offset += n
    metrics = dict(metrics)
    metrics.update(zip(keys, flat[offset:]))
    if "nseg" in metrics:
        metrics["nseg"] = all_reduce(
            metrics["nseg"].float().reshape(1).clone(), mesh, mesh.world,
            op="max")[0]
    if table is not None:
        joined[table] = tp.join_table(grads[table])
    return joined, metrics
