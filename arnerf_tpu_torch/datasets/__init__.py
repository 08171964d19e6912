"""Dataset registry (port of arnerf_tpu/datasets/__init__.py; reference
datasets/__init__.py:11-17): the procedural `synthetic` scene, the four
LDR loaders and the three OpenEXR loaders. `rtmv` is not ported:
`unported_reason` says why."""

from .colmap import ColmapDataset
from .colmap_exr import ColmapEXRDataset
from .colmap_real_exr import ColmapRealEXRDataset
from .myblender import MyBlenderDataset
from .nerf import NeRFDataset
from .nerfpp import NeRFPPDataset
from .nsvf import NSVFDataset
from .synthetic import SyntheticDataset

dataset_dict = {
    "synthetic": SyntheticDataset,
    "nerf": NeRFDataset,
    "nsvf": NSVFDataset,
    "colmap": ColmapDataset,
    "nerfpp": NeRFPPDataset,
    "colmap_exr": ColmapEXRDataset,
    "colmap_real_exr": ColmapRealEXRDataset,
    "myblender": MyBlenderDataset,
}

EXR_DATASETS = ("colmap_exr", "colmap_real_exr", "myblender")

UNPORTED = {
    "rtmv": "RTMV ships OpenEXR frames, which the JAX loader "
            "(arnerf_tpu/datasets/rtmv.py:61) sends through the LDR branch "
            "of read_image (decoded as an LDR image and divided by 255); "
            "the port does not copy that fault (ROADMAP section 3)"}


def unported_reason(name: str):
    """None for a dataset the port loads, else why it does not."""
    if name in dataset_dict:
        return None
    reason = UNPORTED.get(name, "no such dataset")
    return f"dataset {name!r} is not ported to arnerf_tpu_torch: {reason}"


def loader_kwargs(hparams, device, **extra) -> dict:
    """A loader's keyword arguments from the CLI flags (the JAX train.py:52-56
    and insert/main.py:86-91): root_dir, downsample, the device, and
    use_EXR for the OpenEXR datasets when --use_EXR is given."""
    kwargs = {"root_dir": hparams.root_dir, "downsample": hparams.downsample,
              "device": device, **extra}
    if hparams.use_EXR and hparams.dataset_name in EXR_DATASETS:
        kwargs["use_EXR"] = True
    return kwargs
