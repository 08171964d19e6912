"""The NGP radiance field and its occupancy-grid state (port of
arnerf_tpu/models/ngp.py; reference: models/networks.py:12-281).

Parameters are a plain dict of tensors with the JAX package's layout
(`hash_table`, `sigma_mlp` [W0, W1], `rgb_mlp` [V0, V1, V2], optional
`tonemappers`), so training/ckpt.py converts checkpoints key for key.

`seed` (a uint32 int) selects the stochastic single-corner hash encode on
the training paths (ops/hashgrid.py); None is the exact trilerp.

The occupancy grid is maintained by `mark_invisible_cells` and
`update_density_grid`. The latter is split in two: a deterministic core
that takes the sampled cells, the jitter uniforms and the corner seed, and
a wrapper that draws them from torch generators (jax.random's draws cannot
be reproduced in torch, so the parity tests feed the core JAX's draws).
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.hashgrid import (HashGridConfig, hashgrid_init, hashgrid_encode,
                            ngp_growth_factor)
from ..ops.packbits import packbits
from ..ops.segments import dense_segment_max
from ..ops.stepping import fma
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


NEAR_DISTANCE = 0.01  # reference: models/rendering.py:10


def _encode(params, x, cfg: NGPConfig, seed=None):
    xn = (x + cfg.scale) / (2 * cfg.scale)
    table = params["hash_table"].to(cfg.cdtype)
    return hashgrid_encode(table, xn, cfg.hash_cfg, seed=seed)


def ngp_density(params, x, cfg: NGPConfig, return_feat: bool = False,
                seed=None):
    """x: (N, 3) world positions in [-scale, scale]^3 -> sigmas (N,).
    seed: None, or a uint32 int for stochastic-corner hash gathers.
    reference: models/networks.py:95-108."""
    feats = _encode(params, x, cfg, seed)
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
                output_radiance: bool = False, seed=None):
    """x, d: (N, 3) -> (sigmas (N,), rgbs (N, 3)).
    seed: None, or a uint32 int for stochastic-corner hash gathers.
    reference: models/networks.py:133-165."""
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    d_enc = sh_encode(d)
    if cfg.fused_head:
        from ..ops.fused_head import fused_field_head, \
            head_weights_from_params
        feats = _encode(params, x, cfg, seed)
        h, rgbs = fused_field_head(feats, d_enc,
                                   head_weights_from_params(params),
                                   cfg.cdtype)
        sigmas = trunc_exp(h[:, 0])
        if cfg.rgb_act == "Sigmoid":
            rgbs = torch.sigmoid(rgbs)
    else:
        sigmas, h = ngp_density(params, x, cfg, return_feat=True, seed=seed)
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
                        output_radiance: bool = False, chunk: int = 1 << 18,
                        seed=None):
    """ngp_forward over large point sets in chunks of `chunk` rows. A render
    round holds ~2M samples; unchunked, the (N, 16, 8) int64 hash-index
    tensor alone would take 2 GB. Chunk i takes seed + i: the hash RNG's
    counter is local to each call, so chunks would otherwise share their
    corner draws (ngp.py:395-401)."""
    n = x.shape[0]
    if n <= chunk:
        return ngp_forward(params, x, d, cfg, exposure=exposure,
                           output_radiance=output_radiance, seed=seed)
    sig, col = [], []
    for ci, i in enumerate(range(0, n, chunk)):
        e = None if exposure is None else exposure[i:i + chunk]
        s, c = ngp_forward(params, x[i:i + chunk], d[i:i + chunk], cfg,
                           exposure=e, output_radiance=output_radiance,
                           seed=None if seed is None else seed + ci)
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


def _cell_coords(idx, G: int):
    """Linear cell index -> integer (x, y, z), layout [x, y, z] row-major
    (ops/marching.py's flat index ((c*G + x)*G + y)*G + z)."""
    return torch.stack([idx // (G * G), (idx // G) % G, idx % G], dim=-1)


def _cells_to_world(coords, mip, cfg: NGPConfig, jitter=None):
    """Grid coords (+ optional in-cell jitter from uniforms `jitter`, same
    shape as coords) -> world xyz for cascade mip.
    reference: models/networks.py:263-267."""
    G = cfg.grid_size
    s = torch.clamp(torch.exp2(mip.to(torch.float32) - 1.0), max=cfg.scale)
    half = s / G
    xyz = coords.to(torch.float32) / (G - 1) * 2.0 - 1.0
    xyz = xyz * (s - half)[..., None]
    if jitter is not None:
        # one rounding, as XLA contracts the jitter into an FMA
        xyz = fma(jitter * 2.0 - 1.0, half[..., None], xyz)
    return xyz


@torch.no_grad()
def _chunked_density(params, cfg: NGPConfig, xyz, chunk: int = 1 << 18,
                     seed=None):
    """ngp_density over a large point set in chunks; chunk i takes seed + i
    (the hash RNG's counter is local to each call, ngp.py:237-242)."""
    return torch.cat([
        ngp_density(params, xyz[i:i + chunk], cfg,
                    seed=None if seed is None else seed + ci)
        for ci, i in enumerate(range(0, xyz.shape[0], chunk))])


@torch.no_grad()
def mark_invisible_cells(state: GridState, K, poses, cfg: NGPConfig,
                         img_w: int, img_h: int,
                         chunk: int = 1 << 16) -> GridState:
    """Flag cells outside every camera frustum with density -1 (never
    occupied); store per-cell camera coverage in count_grid. Visible cells
    keep any trained density (checkpoint resumes).
    reference: models/networks.py:209-250."""
    G, C = cfg.grid_size, cfg.cascades
    G3 = G ** 3
    dev = state.density_grid.device
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    n_cams = poses.shape[0]
    w2c_R = poses[:, :3, :3].transpose(1, 2)                   # (N, 3, 3)
    w2c_T = -torch.einsum("nij,nj->ni", w2c_R, poses[:, :3, 3])
    coords = _cell_coords(torch.arange(G3, device=dev), G)
    counts, grids = [], []
    for c in range(C):
        mip = torch.full((G3,), c, dtype=torch.int64, device=dev)
        xyz = _cells_to_world(coords, mip, cfg)
        count, too_near = [], []
        for i in range(0, G3, chunk):
            x = xyz[i:i + chunk]
            xc = torch.einsum("nij,mj->nmi", w2c_R, x) + w2c_T[:, None, :]
            uvd = torch.einsum("ij,nmj->nmi", K, xc)          # (N, m, 3)
            z = uvd[..., 2:]
            uv = uvd[..., :2] / torch.where(torch.abs(z) > 1e-9, z, 1e-9)
            in_image = ((uvd[..., 2] >= 0)
                        & (uv[..., 0] >= 0) & (uv[..., 0] < img_w)
                        & (uv[..., 1] >= 0) & (uv[..., 1] < img_h))
            covered = (uvd[..., 2] >= NEAR_DISTANCE) & in_image
            # times the float32 reciprocal, as XLA rewrites the division
            count.append(covered.sum(dim=0).to(torch.float32)
                         * float(np.float32(1.0 / n_cams)))
            too_near.append(((uvd[..., 2] < NEAR_DISTANCE)
                             & in_image).any(dim=0))
        count = torch.cat(count)
        valid = (count > 0) & ~torch.cat(too_near)
        prior = torch.clamp(state.density_grid[c], min=0.0)
        counts.append(count)
        grids.append(torch.where(valid, prior, -1.0))
    return state._replace(density_grid=torch.stack(grids),
                          count_grid=torch.stack(counts))


@torch.no_grad()
def update_density_grid_core(params, state: GridState, cfg: NGPConfig,
                             density_threshold: float, idx, jitter,
                             seed=None, decay: float = 0.95,
                             erode: bool = False) -> GridState:
    """EMA density-grid maintenance for given draws.
    reference: models/networks.py:252-281.

    idx: None in warmup (every cell, in order), else (C, m) sampled cell
    indices per cascade; jitter: (C*m, 3) uniforms in [0, 1) for the
    in-cell positions; seed: None or the uint32 corner seed of the density
    probes. Duplicate cells are benign: their densities meet in a
    scatter-max (unlike the reference's last-write-wins)."""
    G, C = cfg.grid_size, cfg.cascades
    G3 = G ** 3
    dev = state.density_grid.device
    warmup = idx is None
    if warmup:
        idx = torch.arange(G3, device=dev).expand(C, G3)
    mips = torch.arange(C, device=dev)[:, None].expand(idx.shape)
    coords = _cell_coords(idx.reshape(-1), G)
    xyz = _cells_to_world(coords, mips.reshape(-1), cfg, jitter=jitter)
    sig = _chunked_density(params, cfg, xyz, seed=seed)
    if warmup:
        tmp = sig.reshape(C, G3)    # every cell exactly once
    else:
        # sigma >= 0 (trunc_exp), so fill 0 is the zero-init scatter-max
        rows = mips.reshape(-1) * G3 + idx.reshape(-1)
        tmp = dense_segment_max(rows, sig.float(), C * G3,
                                fill=0.0).reshape(C, G3)
    if erode:
        # decay harder where few cameras see the cell (reference :270-272)
        decay_g = torch.clamp(
            decay ** (1.0 / torch.clamp(state.count_grid, min=1e-6)),
            0.1, 0.95)
    else:
        decay_g = decay
    dg = state.density_grid
    grid = torch.where(dg < 0, dg, torch.maximum(dg * decay_g, tmp))
    pos = grid > 0
    mean_density = torch.sum(torch.where(pos, grid, 0.0)) \
        / torch.clamp(pos.sum(), min=1)
    thr = torch.clamp(mean_density, max=density_threshold)
    return GridState(density_grid=grid, count_grid=state.count_grid,
                     occ_flat=(grid > thr).to(torch.uint8).reshape(-1),
                     bitfield=packbits(grid.reshape(-1), thr))


def occupied_cells(density_grid, density_threshold: float, u):
    """Inverse-CDF draw of occupied cells: u (C, M) uniforms in [0, 1) ->
    (C, M) cell indices of cells with density > threshold (uniform over
    them; any cell where none is occupied). No (M, G^3) categorical."""
    from ..ops.marching import _lower_bound_rows
    C, G3 = density_grid.shape
    cdf = torch.cumsum((density_grid > density_threshold).to(torch.float32),
                       dim=-1)
    q = u * torch.clamp(cdf[:, -1:], min=1e-9)
    rows = torch.arange(C, device=u.device)[:, None].expand(q.shape)
    occ_idx = _lower_bound_rows(cdf.reshape(-1), rows.reshape(-1),
                                q.reshape(-1), G3).reshape(q.shape)
    return torch.clamp(occ_idx, max=G3 - 1)


def update_density_grid(params, state: GridState, cfg: NGPConfig,
                        density_threshold: float, warmup: bool,
                        generator: torch.Generator, decay: float = 0.95,
                        erode: bool = False) -> GridState:
    """update_density_grid_core with draws from `generator` (on the grid's
    device): warmup evaluates every cell; otherwise G^3/4 uniform cells plus
    G^3/4 cells drawn from the occupied set, per cascade. With
    cfg.stoch_corners the density probes use stochastic corners."""
    G, C = cfg.grid_size, cfg.cascades
    G3 = G ** 3
    dev = state.density_grid.device
    seed = None
    if cfg.stoch_corners:
        seed = int(torch.randint(0, 1 << 32, (), generator=generator,
                                 device=dev))
    idx = None
    if not warmup:
        M = G3 // 4
        uniform_idx = torch.randint(0, G3, (C, M), generator=generator,
                                    device=dev)
        u = torch.rand((C, M), generator=generator, device=dev)
        idx = torch.cat([uniform_idx, occupied_cells(
            state.density_grid, density_threshold, u)], dim=1)
    m = G3 if warmup else idx.shape[1]
    jitter = torch.rand((C * m, 3), generator=generator, device=dev)
    return update_density_grid_core(params, state, cfg, density_threshold,
                                    idx, jitter, seed=seed, decay=decay,
                                    erode=erode)
