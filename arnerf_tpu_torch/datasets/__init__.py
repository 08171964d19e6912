"""Dataset registry (port of arnerf_tpu/datasets/__init__.py; reference
datasets/__init__.py:11-17): the procedural `synthetic` scene, the five
LDR loaders (rtmv reads the PNGs prepare_rtmv writes) and the three
OpenEXR loaders."""

from .colmap import ColmapDataset
from .colmap_exr import ColmapEXRDataset
from .colmap_real_exr import ColmapRealEXRDataset
from .myblender import MyBlenderDataset
from .nerf import NeRFDataset
from .nerfpp import NeRFPPDataset
from .nsvf import NSVFDataset
from .rtmv import RTMVDataset
from .synthetic import SyntheticDataset

dataset_dict = {
    "synthetic": SyntheticDataset,
    "nerf": NeRFDataset,
    "nsvf": NSVFDataset,
    "colmap": ColmapDataset,
    "nerfpp": NeRFPPDataset,
    "rtmv": RTMVDataset,
    "colmap_exr": ColmapEXRDataset,
    "colmap_real_exr": ColmapRealEXRDataset,
    "myblender": MyBlenderDataset,
}

EXR_DATASETS = ("colmap_exr", "colmap_real_exr", "myblender")


def unported_reason(name: str):
    """None for a dataset the port loads, else why it does not."""
    if name in dataset_dict:
        return None
    return f"dataset {name!r} is not ported to arnerf_tpu_torch: no such " \
        "dataset"


def loader_kwargs(hparams, device, **extra) -> dict:
    """A loader's keyword arguments from the CLI flags (the JAX train.py:52-56
    and insert/main.py:86-91): root_dir, downsample, the device, and
    use_EXR for the OpenEXR datasets when --use_EXR is given."""
    kwargs = {"root_dir": hparams.root_dir, "downsample": hparams.downsample,
              "device": device, **extra}
    if hparams.use_EXR and hparams.dataset_name in EXR_DATASETS:
        kwargs["use_EXR"] = True
    return kwargs
