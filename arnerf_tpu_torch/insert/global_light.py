"""Planar-region extraction and probe precomputation for global-light
estimation (port of arnerf_tpu/insert/global_light.py; reference
insert/global_light.py).

Plane RANSAC is vectorised numpy (the reference uses pyransac3d,
global_light.py:51-84), the same code as the JAX package's, so that it
picks the same planes from the same `default_rng`: fit the dominant plane,
keep it if it has enough inliers, orient its normal against the mean
surface normal of its inliers, remove them and repeat.
"""

import os

import numpy as np

from .sh_math import write2ply


def ransac_plane(pts, thresh=0.02, n_iters=256, rng=None):
    """Best-plane RANSAC. pts: (n, 3). Returns (eq (4,), inlier_idx)."""
    rng = rng or np.random.default_rng(0)
    n = pts.shape[0]
    tri = rng.integers(0, n, size=(n_iters, 3))
    p0, p1, p2 = pts[tri[:, 0]], pts[tri[:, 1]], pts[tri[:, 2]]
    nrm = np.cross(p1 - p0, p2 - p0)                          # (it, 3)
    norm_len = np.linalg.norm(nrm, axis=1, keepdims=True)
    ok = norm_len[:, 0] > 1e-12
    nrm = nrm / np.maximum(norm_len, 1e-12)
    d = -np.sum(nrm * p0, axis=1)                             # (it,)
    # distance of all points to all candidate planes, in chunks to bound mem
    best_cnt = -1
    best = None
    chunk = max(1, (1 << 24) // max(n, 1))
    for i in range(0, n_iters, chunk):
        dist = np.abs(pts @ nrm[i:i + chunk].T + d[None, i:i + chunk])
        cnt = np.sum(dist < thresh, axis=0)
        cnt[~ok[i:i + chunk]] = -1
        j = int(np.argmax(cnt))
        if cnt[j] > best_cnt:
            best_cnt = int(cnt[j])
            best = i + j
    eq = np.concatenate([nrm[best], [d[best]]])
    inliers = np.where(np.abs(pts @ eq[:3] + eq[3]) < thresh)[0]
    return eq, inliers


class GlobalLightEstimator:
    """reference insert/global_light.py:16-119."""

    def __init__(self, gen_path, pts_use=int(2e6), write_ply=False, rng=None):
        self.calc_complete = False
        self.write_ply = write_ply
        self.rng = rng or np.random.default_rng(0)
        self.save_path = os.path.join(gen_path, 'plane.npy')
        if os.path.exists(self.save_path):
            infos = np.load(self.save_path, allow_pickle=True).item()
            self.t_rgbs = infos['rgbs'].reshape(-1, 3)
            self.t_pts = infos['spts'].reshape(-1, 3)
            self.t_normal = infos['normals'].reshape(-1, 3)
            if 'rgb_shs' in infos:
                self.t_rgb_shs = infos['rgb_shs']
                self.t_opc_shs = infos['opacity_shs']
            print(f'Find plane infos, {self.t_pts.shape[0]} points will be '
                  f'used in training')
            self.calc_complete = True
        else:
            infos = np.load(os.path.join(gen_path, 'surface.npy'),
                            allow_pickle=True).item()
            s_rgbs = infos['rgbs'].reshape(-1, 3)
            s_pts = infos['spts'].reshape(-1, 3)
            s_normals = infos['normals'].reshape(-1, 3)
            idx = self.rng.permutation(s_pts.shape[0])[:pts_use]
            self.s_rgbs = s_rgbs[idx]
            self.s_pts = s_pts[idx]
            self.s_normals = s_normals[idx]
            self.pts_num = len(idx)
            self.t_rgbs, self.t_pts, self.t_normal = [], [], []

    def detect_planar_patch(self, min_pts_in_plane=1e5, thresh=0.02):
        """Peel off dominant planes until the next has too few inliers
        (reference global_light.py:51-84)."""
        pt_c, rgb_c, norm_c = self.s_pts, self.s_rgbs, self.s_normals
        if self.write_ply:
            self.rgb_msk = []
        while len(pt_c) > 3:
            eq, inliers = ransac_plane(pt_c, thresh, rng=self.rng)
            if inliers.shape[0] < min_pts_in_plane:
                break
            normal = eq[:3].reshape(1, 3)
            mean_raw = np.mean(norm_c[inliers], 0, keepdims=True)
            if np.sum(normal * mean_raw) < 0:
                normal = -normal
            normal = normal / np.linalg.norm(normal)
            print('Find plane, normal:', normal)
            self.t_rgbs.append(rgb_c[inliers])
            self.t_pts.append(pt_c[inliers])
            self.t_normal.append(np.repeat(normal, len(inliers), axis=0))
            if self.write_ply:
                self.rgb_msk.append(np.repeat(
                    self.rng.random((1, 3)), len(inliers), axis=0))
            mask = np.ones(pt_c.shape[0], dtype=bool)
            mask[inliers] = False
            pt_c, rgb_c, norm_c = pt_c[mask], rgb_c[mask], norm_c[mask]

        self.t_rgbs = np.concatenate(self.t_rgbs, 0)
        self.t_pts = np.concatenate(self.t_pts, 0)
        self.t_normal = np.concatenate(self.t_normal, 0)

    def save_results(self, insertor=None, batch=4096):
        """Optionally precompute per-point rgb/opacity SH probes through the
        NeRF (reference global_light.py:86-114)."""
        save_dict = {'spts': self.t_pts, 'rgbs': self.t_rgbs,
                     'normals': self.t_normal}
        if insertor is not None:
            rgb_shs, opc_shs = [], []
            print('Precompute probes ...')
            n = self.t_pts.shape[0]
            for i in range(0, n, batch):
                ed = min(i + batch, n)
                pts = self.t_pts[i:ed] + self.t_normal[i:ed] * 0.01
                r, o = insertor.generate_sh_probes_for_precompute(pts)
                rgb_shs.append(r.cpu().numpy())
                opc_shs.append(o.cpu().numpy())
            self.t_rgb_shs = np.concatenate(rgb_shs, 0)    # (x, 9, 3)
            self.t_opc_shs = np.concatenate(opc_shs, 0)    # (x, 9, 1)
            save_dict.update({'rgb_shs': self.t_rgb_shs,
                              'opacity_shs': self.t_opc_shs})
        print(f'{self.t_pts.shape[0]} points will be used in training')
        np.save(self.save_path, save_dict, allow_pickle=True)
        if self.write_ply:
            self.rgb_msk = np.concatenate(self.rgb_msk, 0)
            write2ply(self.s_rgbs, self.s_pts, './scene_sample.ply')
            write2ply(self.rgb_msk, self.t_pts, './scene_plane.ply')
