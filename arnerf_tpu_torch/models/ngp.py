"""The NGP radiance field and its occupancy-grid state (port of
arnerf_tpu/models/ngp.py; reference: models/networks.py:12-281).

Parameters are a plain dict of tensors with the JAX package's layout
(`hash_table`, `sigma_mlp` [W0, W1], `rgb_mlp` [V0, V1, V2], optional
`tonemappers`), so training/ckpt.py converts checkpoints key for key.

The occupancy-grid updates (update_density_grid, mark_invisible_cells)
come with the training path; the render path only reads `occ_flat`.
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.hashgrid import (HashGridConfig, hashgrid_init, hashgrid_encode,
                            ngp_growth_factor)
from ..ops.sh import sh_encode
from ..ops.trunc_exp import trunc_exp
from .mlp import mlp_init, mlp_apply


@dataclass(frozen=True)
class NGPConfig:
    scale: float = 0.5
    rgb_act: str = "Sigmoid"        # 'Sigmoid' | 'None' (HDR log-radiance)
    use_raw_hdr: bool = False
    grid_size: int = 128
    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    sigma_hidden: int = 64
    sigma_out: int = 16
    rgb_hidden: int = 64
    # 'bfloat16' rounds the hash table and every MLP operand to bf16
    # (float32 accumulation); parameters stay float32
    compute_dtype: str = "float32"
    # evaluate the sigma+rgb MLP pair with the fused head (CUDA kernel on
    # the card, its plain version on the CPU); False = separate matmuls
    fused_head: bool = False
    # single-corner stochastic hash gathers on the training paths; the
    # render path is exact regardless (kept for config parity)
    stoch_corners: bool = False

    @property
    def cdtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32

    @property
    def cascades(self) -> int:
        # reference: models/networks.py:27
        return max(1 + int(np.ceil(np.log2(2 * self.scale))), 1)

    @property
    def hash_cfg(self) -> HashGridConfig:
        return HashGridConfig(
            n_levels=self.n_levels, n_features=self.n_features,
            log2_hashmap_size=self.log2_hashmap_size,
            base_resolution=self.base_resolution,
            per_level_scale=ngp_growth_factor(
                self.scale, self.n_levels, self.base_resolution))

    @property
    def has_tonemappers(self) -> bool:
        # reference: models/networks.py:80
        return self.rgb_act == "None" and not self.use_raw_hdr


def ngp_init(cfg: NGPConfig, generator: torch.Generator = None,
             device="cpu") -> dict:
    """Random parameters drawn from `generator` (CPU draws, so a seed gives
    the same weights on every device)."""
    params = {
        "hash_table": hashgrid_init(cfg.hash_cfg, generator, device),
        # 32 -> 64 -> 16; first output channel is the (log) density
        "sigma_mlp": mlp_init(cfg.hash_cfg.out_dim, cfg.sigma_hidden,
                              cfg.sigma_out, 1, generator, device),
        # (16 SH + 16 feat) -> 64 -> 64 -> 3
        "rgb_mlp": mlp_init(16 + cfg.sigma_out, cfg.rgb_hidden, 3, 2,
                            generator, device),
    }
    if cfg.has_tonemappers:
        params["tonemappers"] = [mlp_init(1, 64, 1, 1, generator, device)
                                 for _ in range(3)]
    return params


def _encode(params, x, cfg: NGPConfig):
    xn = (x + cfg.scale) / (2 * cfg.scale)
    table = params["hash_table"].to(cfg.cdtype)
    return hashgrid_encode(table, xn, cfg.hash_cfg)


def ngp_density(params, x, cfg: NGPConfig, return_feat: bool = False):
    """x: (N, 3) world positions in [-scale, scale]^3 -> sigmas (N,).
    reference: models/networks.py:95-108."""
    feats = _encode(params, x, cfg)
    h = mlp_apply(params["sigma_mlp"], feats, dtype=cfg.cdtype)
    sigmas = trunc_exp(h[:, 0].float())
    if return_feat:
        return sigmas, h
    return sigmas


def ngp_log_radiance_to_rgb(params, log_radiances, exposure=None):
    """HDR-NeRF tonemapping heads. reference: models/networks.py:110-131."""
    log_exposure = 0.0 if exposure is None else torch.log(exposure)
    outs = []
    for i in range(3):
        inp = log_radiances[:, i:i + 1] + log_exposure
        outs.append(mlp_apply(params["tonemappers"][i], inp,
                              out_activation="sigmoid"))
    return torch.cat(outs, dim=1)


def ngp_forward(params, x, d, cfg: NGPConfig, exposure=None,
                output_radiance: bool = False):
    """x, d: (N, 3) -> (sigmas (N,), rgbs (N, 3)).
    reference: models/networks.py:133-165."""
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    d_enc = sh_encode(d)
    if cfg.fused_head:
        from ..ops.fused_head import fused_field_head, \
            head_weights_from_params
        feats = _encode(params, x, cfg)
        h, rgbs = fused_field_head(feats, d_enc,
                                   head_weights_from_params(params),
                                   cfg.cdtype)
        sigmas = trunc_exp(h[:, 0])
        if cfg.rgb_act == "Sigmoid":
            rgbs = torch.sigmoid(rgbs)
    else:
        sigmas, h = ngp_density(params, x, cfg, return_feat=True)
        rgb_in = torch.cat([d_enc.to(cfg.cdtype), h.to(cfg.cdtype)], dim=1)
        act = "sigmoid" if cfg.rgb_act == "Sigmoid" else None
        rgbs = mlp_apply(params["rgb_mlp"], rgb_in, out_activation=act,
                         dtype=cfg.cdtype)

    if cfg.use_raw_hdr:
        # raw-HDR EXR training: leaky relu in training, relu for final output
        rgbs = torch.relu(rgbs) if output_radiance \
            else torch.nn.functional.leaky_relu(rgbs, 0.01)
    elif cfg.rgb_act == "None":
        if output_radiance:  # HDR map output
            rgbs = trunc_exp(torch.clamp(rgbs, 0.0, 20.0))
        else:                # LDR via the tonemapper heads
            rgbs = ngp_log_radiance_to_rgb(params, rgbs, exposure)
    return sigmas, rgbs


def ngp_forward_chunked(params, x, d, cfg: NGPConfig, exposure=None,
                        output_radiance: bool = False, chunk: int = 1 << 18):
    """ngp_forward over large point sets in chunks of `chunk` rows. A render
    round holds ~2M samples; unchunked, the (N, 16, 8) int64 hash-index
    tensor alone would take 2 GB."""
    n = x.shape[0]
    if n <= chunk:
        return ngp_forward(params, x, d, cfg, exposure=exposure,
                           output_radiance=output_radiance)
    sig, col = [], []
    for i in range(0, n, chunk):
        e = None if exposure is None else exposure[i:i + chunk]
        s, c = ngp_forward(params, x[i:i + chunk], d[i:i + chunk], cfg,
                           exposure=e, output_radiance=output_radiance)
        sig.append(s)
        col.append(c)
    return torch.cat(sig), torch.cat(col)


# --------------------------------------------------------------------------
# Occupancy grid
# --------------------------------------------------------------------------

class GridState(NamedTuple):
    density_grid: torch.Tensor  # (C, G^3) float32; -1 marks invisible cells
    count_grid: torch.Tensor    # (C, G^3) float32 camera-coverage fraction
    occ_flat: torch.Tensor      # (C*G^3,) uint8 0/1, marching layout [c,x,y,z]
    bitfield: torch.Tensor      # (C*G^3//8,) uint8 packed (parity artifact)


def grid_state_init(cfg: NGPConfig, device="cpu") -> GridState:
    C, G3 = cfg.cascades, cfg.grid_size ** 3
    return GridState(
        density_grid=torch.zeros((C, G3), dtype=torch.float32, device=device),
        count_grid=torch.zeros((C, G3), dtype=torch.float32, device=device),
        occ_flat=torch.zeros((C * G3,), dtype=torch.uint8, device=device),
        bitfield=torch.zeros((C * G3 // 8,), dtype=torch.uint8,
                             device=device),
    )
