"""Checkpoint save/load on the JAX package's .npz layout (port of
arnerf_tpu/training/ckpt.py).

Keys are path-flattened: `params/hash_table`, `params/sigma_mlp/0`,
`params/rgb_mlp/2`, `params/tonemappers/1/0`, `grid/occ_flat`, ... A
checkpoint written by the JAX trainer loads here through `params_from_jax`,
and one written here loads in the JAX package.

Optimizer state is stored as its leaves, `opt/<i>`, in the order of optax's
Adam state (training/ckpt.py:37-44 of the JAX package): the step count,
the first moments and the second moments in the parameters' sorted-key
order (`tree_leaves`), then the schedule's count. Each package resumes
from the other's checkpoint.

A trainer whose hash table is row-sharded (parallel/tp.py) saves the full
unpadded table and moments (`gather_unpadded`) and shards what it loads
(`pad_and_shard`), so its checkpoints are an unsharded trainer's, in
either package (the JAX trainer.py:966-1013).

The JAX package's .orbax checkpoints (orbax is a JAX library) are refused
by name on load and on save.
"""

import os

import numpy as np
import torch

from ..parallel.tp import pad_tree, padded_rows, tree_map, unpad_tree


def _numpy(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = _numpy(tree)
    return out


def _listify(node):
    """Nested dicts whose keys are all 0..n-1 become lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node) \
            and sorted(int(k) for k in node) == list(range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def params_from_jax(flat: dict, device="cpu") -> dict:
    """JAX parameters as flat numpy arrays in the checkpoint layout
    ({'params/hash_table': ..., 'params/sigma_mlp/0': ..., ...}) -> the
    port's parameter dict of tensors on `device`. Keys outside `params/`
    are ignored. Weights keep their (in, out) orientation."""
    tree = {}
    for key, value in flat.items():
        if not key.startswith("params/"):
            continue
        parts = key.split("/")[1:]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(value)).to(device)
    return _listify(tree)


def tree_leaves(tree) -> list:
    """Leaves in jax.tree.leaves order: dict keys sorted, sequences in
    order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def _refuse_orbax(path):
    if str(path).rstrip("/").endswith(".orbax"):
        raise ValueError(f"{path}: orbax checkpoints (the JAX package's "
                         f"save_ckpt_orbax) are a JAX format; the port "
                         f"reads and writes the .npz layout only")


def save_ckpt(path, *, params, grid_state=None, opt_state=None, step=0):
    """opt_state: the optimizer's leaves (see the module note), or None."""
    _refuse_orbax(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blobs = {"step": np.asarray(step)}
    blobs.update(_flatten(params, "params/"))
    if grid_state is not None:
        blobs.update(_flatten(grid_state._asdict(), "grid/"))
    if opt_state is not None:
        blobs["opt_n_leaves"] = np.asarray(len(opt_state))
        for i, leaf in enumerate(opt_state):
            blobs[f"opt/{i}"] = _numpy(leaf)
    # atomic write: a kill mid-save must never corrupt an existing ckpt
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **blobs)
    os.replace(tmp, path)


def load_ckpt(path, *, params_template=None, grid_template=None,
              device="cpu"):
    """Load a checkpoint. Returns (params, grid_state, step). Parameters
    missing from the file keep the template's values; grid fields missing
    from the file keep `grid_template`'s (so slim checkpoints load)."""
    _refuse_orbax(path)
    with np.load(path, allow_pickle=False) as f:
        blobs = dict(f)
    params = params_from_jax(blobs, device)
    if params_template is not None:
        params = _merge(params_template, params)
    grid_state = grid_template
    if grid_template is not None:
        fields = {k: (torch.from_numpy(blobs[f"grid/{k}"]).to(device)
                      if f"grid/{k}" in blobs else v)
                  for k, v in grid_template._asdict().items()}
        grid_state = type(grid_template)(**fields)
    return params, grid_state, int(blobs.get("step", 0))


def _merge(template, loaded):
    if isinstance(template, dict):
        loaded = loaded if isinstance(loaded, dict) else {}
        return {k: _merge(v, loaded.get(k)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        loaded = loaded if isinstance(loaded, list) else []
        return [_merge(v, loaded[i] if i < len(loaded) else None)
                for i, v in enumerate(template)]
    if loaded is None:
        return template
    if tuple(loaded.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint tensor of shape {tuple(loaded.shape)} "
                         f"does not fit the model's {tuple(template.shape)}")
    return loaded


def load_opt_state(path, n_leaves: int, device="cpu"):
    """The optimizer leaves of a checkpoint as tensors on `device`, or None
    when it holds none (slim checkpoints)."""
    with np.load(path, allow_pickle=False) as f:
        if "opt/0" not in f:
            return None
        n = int(f["opt_n_leaves"]) if "opt_n_leaves" in f else n_leaves
        if n != n_leaves:
            raise ValueError(f"checkpoint optimizer state has {n} leaves but "
                             f"the optimizer has {n_leaves}")
        return [torch.from_numpy(np.array(f[f"opt/{i}"])).to(device)
                for i in range(n)]


def slim_ckpt(path_in, path_out):
    """Strip a checkpoint for distribution: model weights plus the
    occupancy decision (the reference keeps the density bitfield,
    utils.py:29-39)."""
    with np.load(path_in, allow_pickle=False) as f:
        blobs = dict(f)
    keep = {k: v for k, v in blobs.items()
            if k.startswith("params/") or k in ("grid/occ_flat",
                                                 "grid/bitfield")}
    keep["step"] = blobs.get("step", np.asarray(0))
    np.savez(path_out, **keep)


def gather_unpadded(tree, tp):
    """Every table shard in `tree` (parameters, optimizer leaves) -> the
    full unpadded table. A collective: every rank of the mesh calls it."""
    gathered = tree_map(lambda leaf: tp.gather(leaf) if tp.is_shard(leaf)
                        else leaf, tree)
    return unpad_tree(gathered, tp.total_entries, tp.n_features, tp.n_mp)


def pad_and_shard(tree, tp):
    """Inverse of gather_unpadded: every full-table leaf of `tree` padded
    to the mesh and cut to this rank's rows."""
    padded = (padded_rows(tp.total_entries, tp.n_mp), tp.n_features)
    return tree_map(lambda leaf: tp.shard(leaf)
                    if tuple(getattr(leaf, "shape", ())) == padded else leaf,
                    pad_tree(tree, tp.total_entries, tp.n_features, tp.n_mp))
