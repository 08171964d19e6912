"""Isosurface extraction via marching tetrahedra (port of
arnerf_tpu/utils/mesh.py, which replaces the reference's mcubes + trimesh
cell of test.ipynb).

Each grid cell splits into six tetrahedra around its main diagonal; each
tetrahedron's 16 sign patterns reduce to "one vertex inside" (1 triangle),
"two inside" (2 triangles) or nothing. The JAX package does this in numpy
with a (cells, 8, 3) int64 index array on the host (3.2 GB at resolution
256); here it runs in torch on the field's device, taking each corner's
values as a shifted view of the field and building positions only for the
cells a surface crosses. Same triangles in the same order, same float
types, same welding: the same mesh.
"""

import numpy as np
import torch

# cube corner offsets, index = bit pattern (x, y, z)
_CORNERS = [(x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)]
# 6 tetrahedra sharing the 0-7 main diagonal (indices into _CORNERS)
_TETS = [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
         [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]]


def _tet_triangles(inside):
    """For one sign pattern (4 bools) return triangles as lists of edge
    pairs ((a, b) = interpolate between tet-local vertices a, b)."""
    ins = [i for i in range(4) if inside[i]]
    outs = [i for i in range(4) if not inside[i]]
    if len(ins) == 0 or len(ins) == 4:
        return []
    if len(ins) == 1:
        a = ins[0]
        return [[(a, outs[0]), (a, outs[1]), (a, outs[2])]]
    if len(ins) == 3:
        a = outs[0]
        return [[(a, ins[0]), (a, ins[1]), (a, ins[2])]]
    # two in, two out -> quad -> two triangles
    a, b = ins
    c, d = outs
    return [[(a, c), (a, d), (b, d)], [(a, c), (b, d), (b, c)]]


_CASES = [_tet_triangles([bool(p & (1 << i)) for i in range(4)])
          for p in range(16)]


def marching_tetrahedra(field, threshold, origin=(0, 0, 0), spacing=1.0):
    """field: (X, Y, Z) scalar grid (tensor or array; computed on its
    device) -> numpy (verts (V, 3) float64, faces (F, 3) int32). Surface at
    field == threshold; vertices linearly interpolated."""
    field = torch.as_tensor(field)
    X, Y, Z = field.shape
    dev = field.device
    # the value of each cell's corner k, cells in (x, y, z) C order
    vals = [field[dx:dx + X - 1, dy:dy + Y - 1, dz:dz + Z - 1].reshape(-1)
            for dx, dy, dz in _CORNERS]
    corners = torch.tensor(_CORNERS, dtype=torch.float64, device=dev)

    tris = []
    for tet in _TETS:
        tv = [vals[k] for k in tet]
        pattern = sum((v > threshold).to(torch.int32) << i
                      for i, v in enumerate(tv))
        for p in range(1, 15):
            sel = torch.nonzero(pattern == p).squeeze(1)
            if sel.numel() == 0:
                continue
            base = torch.stack([sel // ((Y - 1) * (Z - 1)),
                                sel // (Z - 1) % (Y - 1),
                                sel % (Z - 1)], -1).to(torch.float64)
            for tri in _CASES[p]:
                pts = []
                for a, b in tri:
                    va, vb = tv[a][sel], tv[b][sel]
                    d = vb - va
                    t = (threshold - va) / torch.where(d.abs() > 1e-12, d,
                                                       1e-12)
                    t = torch.clamp(t, 0.0, 1.0)[:, None]
                    pa = base + corners[tet[a]]
                    pb = base + corners[tet[b]]
                    pts.append(pa * (1 - t) + pb * t)
                tris.append(torch.stack(pts, dim=1))          # (n, 3, 3)
    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    flat = torch.cat(tris, 0).reshape(-1, 3)

    # weld duplicate vertices (np.unique's sorted order, first occurrence)
    key = torch.round(flat / 1e-6).to(torch.int64)
    uniq, inv = torch.unique(key, dim=0, return_inverse=True)
    first = torch.full((len(uniq),), len(flat), dtype=torch.int64,
                       device=dev).scatter_reduce_(
        0, inv, torch.arange(len(flat), device=dev), reduce="amin")
    verts = flat[first]
    faces = inv.reshape(-1, 3).to(torch.int32)
    # degenerate faces out
    keep = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    faces = faces[keep]
    verts = verts * spacing + torch.tensor(origin, dtype=torch.float64,
                                           device=dev)
    return verts.cpu().numpy(), faces.cpu().numpy()


def save_obj(path, verts, faces):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


@torch.no_grad()
def extract_ngp_mesh(params, cfg, resolution=256, threshold=20.0,
                     chunk=1 << 18):
    """Density-field isosurface of a trained NGP (test.ipynb equivalent):
    the density is queried with ngp_density on the parameters' device, in
    chunks of `chunk` grid points, and the tetrahedra run there too."""
    from ..models.ngp import ngp_density
    s = cfg.scale
    dev = params["hash_table"].device
    ax = torch.as_tensor(np.linspace(-s, s, resolution, dtype=np.float32),
                         device=dev)
    n = resolution ** 3
    sig = torch.empty(n, dtype=torch.float32, device=dev)
    for i in range(0, n, chunk):
        idx = torch.arange(i, min(i + chunk, n), device=dev)
        pts = torch.stack([ax[idx // resolution ** 2],
                           ax[idx // resolution % resolution],
                           ax[idx % resolution]], -1)
        sig[i:i + chunk] = ngp_density(params, pts, cfg).float()
    field = sig.reshape(resolution, resolution, resolution)
    spacing = 2 * s / (resolution - 1)
    return marching_tetrahedra(field, threshold, origin=(-s, -s, -s),
                               spacing=spacing)
