"""Dataset registry. Only the procedural `synthetic` scene is ported so far;
the file-based loaders (nerf, nsvf, colmap, ...) come in a later slice."""

from .synthetic import SyntheticDataset

dataset_dict = {
    "synthetic": SyntheticDataset,
}
