"""Base dataset: images/poses/intrinsics as host numpy arrays (port of
arnerf_tpu/datasets/base.py; reference datasets/base.py)."""

import numpy as np


class BaseDataset:
    def __init__(self, root_dir, split="train", downsample=1.0):
        self.root_dir = root_dir
        self.split = split
        self.downsample = downsample
        self.batch_size = 8192
        self.ray_sampling_strategy = "all_images"
        self.rays = np.zeros((0, 0, 3), np.float32)   # (N_images, H*W, 3|4)
        self.poses = np.zeros((0, 3, 4), np.float32)
        self.directions = None                         # (H*W, 3)
        self.K = None
        self.img_wh = (0, 0)

    def read_intrinsics(self):
        raise NotImplementedError

    def __len__(self):
        # reference: 1000 steps per "epoch" for train splits (base.py:17-20)
        if self.split.startswith("train"):
            return 1000
        return len(self.poses)

    def sample_batch(self, rng: np.random.Generator):
        """Host-side ray-batch sampling (reference base.py:22-35)."""
        if self.ray_sampling_strategy == "all_images":
            img_idxs = rng.integers(0, len(self.poses), self.batch_size)
        else:  # same_image
            img_idxs = np.full(self.batch_size,
                               rng.integers(0, len(self.poses)))
        pix_idxs = rng.integers(0, self.img_wh[0] * self.img_wh[1],
                                self.batch_size)
        rays = self.rays[img_idxs, pix_idxs]
        sample = {"img_idxs": img_idxs, "pix_idxs": pix_idxs,
                  "rgb": rays[:, :3]}
        if self.rays.shape[-1] == 4:  # HDR-NeRF data carries exposure
            sample["exposure"] = rays[:, 3:]
        return sample

    def test_item(self, idx):
        sample = {"pose": self.poses[idx], "img_idxs": idx}
        if len(self.rays) > 0:
            rays = self.rays[idx]
            sample["rgb"] = rays[:, :3]
            if rays.shape[1] == 4:
                sample["exposure"] = rays[0, 3]
        return sample
