"""Checkpoint save/load on the JAX package's .npz layout (port of
arnerf_tpu/training/ckpt.py).

Keys are path-flattened: `params/hash_table`, `params/sigma_mlp/0`,
`params/rgb_mlp/2`, `params/tonemappers/1/0`, `grid/occ_flat`, ... A
checkpoint written by the JAX trainer loads here through `params_from_jax`,
and one written here loads in the JAX package. Optimizer state comes with
the training path.
"""

import os

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = (tree.detach().cpu().numpy()
                            if torch.is_tensor(tree) else np.asarray(tree))
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


def save_ckpt(path, *, params, grid_state=None, step=0):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blobs = {"step": np.asarray(step)}
    blobs.update(_flatten(params, "params/"))
    if grid_state is not None:
        blobs.update(_flatten(grid_state._asdict(), "grid/"))
    # atomic write: a kill mid-save must never corrupt an existing ckpt
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **blobs)
    os.replace(tmp, path)


def load_ckpt(path, *, params_template=None, grid_template=None,
              device="cpu"):
    """Load a checkpoint. Returns (params, grid_state, step). Parameters
    missing from the file keep the template's values; grid fields missing
    from the file keep `grid_template`'s (so slim checkpoints load)."""
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
