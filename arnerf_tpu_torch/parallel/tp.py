"""Row-sharded hash table (port of arnerf_tpu/parallel/tp.py).

On a (data, model) layout of `n_dp` x `n_mp` ranks (parallel/mesh.py) the
hash table, 99 % of the parameters and of the Adam state, is padded to a
multiple of `n_mp` rows and row-sharded over the model group, ZeRO-3
style; its Adam `mu` and `nu` are born sharded the same way:

- **read**: each step all-gathers the table's shards over the model group
  (`TableSharding.expand`), so the gather-heavy encode runs on a full
  table; the grid update gathers it too;
- **grad**: the all-gather's backward zero-pads the full table's
  cotangent and reduce-scatters it as a sum over the model group, so each
  rank receives its shard's gradient summed over the model group (what
  JAX's transpose of all_gather delivers);
- **join** (`join_table`): that shard gradient is meaned over the data
  group and divided by `n_mp`, which with every other leaf meaned over all
  ranks (parallel/dp.py) reproduces the all-rank mean of pure DP.

Every rank still draws its own ray batch, so a (dp, mp) run trains as a
dp*mp pure-DP run with the same per-rank draws.

Checkpoints hold the unpadded table (`unpad_tree` on save, `pad_tree` on
load: training/ckpt.py), so they load into sharded and unsharded trainers
of either package.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .accounting import count
from .dp import all_reduce

TABLE_KEY = "hash_table"


def padded_rows(n_rows: int, n_mp: int) -> int:
    return -(-n_rows // n_mp) * n_mp


def _pad_rows(x, pad: int):
    if torch.is_tensor(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return np.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))


def tree_map(f, tree):
    """f over the leaves of nested dicts, lists and tuples (None kept)."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, v) for v in tree)
    return None if tree is None else f(tree)


def _shape(leaf):
    shape = getattr(leaf, "shape", None)
    return None if shape is None else tuple(shape)


def pad_table(params: dict, n_mp: int) -> dict:
    """Pad the table's row count to a multiple of n_mp with zero rows. They
    sit past every level's offset, so the encode never reads them; their
    gradients are zero, so Adam leaves them at zero."""
    t = params[TABLE_KEY]
    pad = padded_rows(t.shape[0], n_mp) - t.shape[0]
    if pad == 0:
        return params
    return {**params, TABLE_KEY: _pad_rows(t, pad)}


def unpad_table(params: dict, total_entries: int) -> dict:
    t = params[TABLE_KEY]
    if t.shape[0] == total_entries:
        return params
    return {**params, TABLE_KEY: t[:total_entries]}


def unpad_tree(tree, total_entries: int, n_features: int, n_mp: int):
    """Strip the alignment padding from every leaf shaped like the padded
    table (parameters and Adam's mu and nu)."""
    padded = (padded_rows(total_entries, n_mp), n_features)
    return tree_map(lambda leaf: leaf[:total_entries]
                    if _shape(leaf) == padded else leaf, tree)


def pad_tree(tree, total_entries: int, n_features: int, n_mp: int):
    """Inverse of unpad_tree: re-align table-shaped leaves to the mesh."""
    pad = padded_rows(total_entries, n_mp) - total_entries
    if pad == 0:
        return tree
    return tree_map(lambda leaf: _pad_rows(leaf, pad)
                    if _shape(leaf) == (total_entries, n_features)
                    else leaf, tree)


def all_gather_rows(shard, mesh):
    """The model group's shards -> the (n_mp * rows, F) padded table."""
    count(mesh, "all_gather", shard)
    full = shard.new_empty((shard.shape[0] * mesh.n_mp,)
                           + tuple(shard.shape[1:]))
    dist.all_gather(list(full.chunk(mesh.n_mp)), shard.contiguous(),
                    group=mesh.model)
    return full


class _Expand(torch.autograd.Function):
    """shard -> full unpadded table; backward: zero-pad, reduce-scatter."""

    @staticmethod
    def forward(ctx, shard, mesh, total_entries):
        ctx.mesh, ctx.rows = mesh, shard.shape[0]
        return all_gather_rows(shard, mesh)[:total_entries]

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        padded = grad.new_zeros((ctx.rows * mesh.n_mp,)
                                + tuple(grad.shape[1:]))
        padded[:grad.shape[0]] = grad
        count(mesh, "reduce_scatter", padded)
        out = grad.new_empty((ctx.rows,) + tuple(grad.shape[1:]))
        dist.reduce_scatter(out, list(padded.chunk(mesh.n_mp)),
                            op=dist.ReduceOp.SUM, group=mesh.model)
        return out, None, None


@dataclass(frozen=True)
class TableSharding:
    """The table's sharding over `mesh`'s model group; threaded through the
    trainer's steps, the grid update and the checkpoints."""
    mesh: object
    total_entries: int
    n_features: int

    @property
    def n_mp(self) -> int:
        return self.mesh.n_mp

    @property
    def shard_rows(self) -> int:
        return padded_rows(self.total_entries, self.n_mp) // self.n_mp

    def shard(self, table):
        """This rank's rows of a full (unpadded or padded) table."""
        t = pad_table({TABLE_KEY: table}, self.n_mp)[TABLE_KEY]
        r = self.shard_rows
        return t[self.mesh.mp_rank * r:(self.mesh.mp_rank + 1) * r].clone()

    def expand(self, params: dict) -> dict:
        """params holding this rank's table shard -> params holding the
        full (total_entries, F) table, inside the autograd graph: the
        gradient that reaches the shard is reduce-scattered over the model
        group."""
        return {**params, TABLE_KEY: _Expand.apply(
            params[TABLE_KEY], self.mesh, self.total_entries)}

    def gather(self, shard):
        """The full padded table of a shard, outside autograd (the grid
        update, checkpoints)."""
        with torch.no_grad():
            return all_gather_rows(shard, self.mesh)

    def is_shard(self, leaf) -> bool:
        return _shape(leaf) == (self.shard_rows, self.n_features)

    def leaf_index(self, leaves) -> int:
        """Index of the table shard among tree_leaves(params)."""
        return next(i for i, p in enumerate(leaves) if self.is_shard(p))

    def join_table(self, grad):
        """The shard's gradient (model-group sum) -> the all-rank mean:
        summed over the data group, divided by n_dp and then by n_mp (JAX:
        pmean over the data axis, then / n_mp)."""
        all_reduce(grad, self.mesh, self.mesh.data)
        return grad.div_(self.mesh.n_dp).div_(self.n_mp)
