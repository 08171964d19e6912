"""Dataset registry (port of arnerf_tpu/datasets/__init__.py; reference
datasets/__init__.py:11-17): the procedural `synthetic` scene and the four
LDR loaders. The EXR loaders are not ported yet: `unported_reason` names
what they wait for."""

from .colmap import ColmapDataset
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
}

_EXR = ("its frames are EXR images, which need an OpenEXR reader; it comes "
        "with the HDR heads and --use_EXR (ROADMAP queue 1, items 5-6)")
UNPORTED = {"colmap_exr": _EXR, "colmap_real_exr": _EXR, "myblender": _EXR,
            "rtmv": _EXR}


def unported_reason(name: str):
    """None for a dataset the port loads, else why it does not yet."""
    if name in dataset_dict:
        return None
    reason = UNPORTED.get(name, "no such dataset")
    return f"dataset {name!r} is not ported to arnerf_tpu_torch yet: {reason}"
