"""PBR shading cores (SH and spherical-Gaussian paths) and cubemap sampling
(port of arnerf_tpu/insert/render_utils.py; reference
insert/render_utils.py). The reference's boolean-mask branches (per-face
cubemap scatter, rough/smooth specular split) are gathers and selects, as
in the JAX package.

SG format: 7 floats = [axis(3), lambda(1), mu/rgb(3)].
"""

import numpy as np
import torch

from .sh_math import latlong_dirs

EPS = 1e-6


def pos_dot(v1, v2):
    return torch.relu(torch.sum(v1 * v2, dim=-1, keepdim=True))


def pos_dot_eps(v1, v2):
    return torch.clamp(torch.sum(v1 * v2, dim=-1, keepdim=True), min=EPS)


def sh9_irradiance(normals, shec, allow_neg=False):
    """Closed-form irradiance from SH9 (Ramamoorthi-Hanrahan; reference
    render_utils.py:19-35). normals (x, 3), shec (x, 9, 3)."""
    c1 = 0.42904276540489171563379376569857
    c2 = 0.51166335397324424423977581244463
    c3 = 0.24770795610037568833406429782001
    c4 = 0.88622692545275801364908374167057
    x = normals[:, 0:1]
    y = normals[:, 1:2]
    z = normals[:, 2:3]
    irr = (c1 * (x ** 2 - y ** 2) * shec[:, 8]
           + c3 * (3.0 * z ** 2 - 1.0) * shec[:, 6]
           + c4 * shec[:, 0]
           + 2.0 * c1 * (shec[:, 4] * x * y + shec[:, 7] * x * z
                         + shec[:, 5] * y * z)
           + 2.0 * c2 * (shec[:, 3] * x + shec[:, 1] * y + shec[:, 2] * z))
    return irr if allow_neg else torch.relu(irr)


def irradiance_numerical(rgbs, rays_d, normals, allow_neg=False):
    """MC cosine-weighted irradiance (reference render_utils.py:42-48).
    rgbs, rays_d: (x, c, 3), normals: (x, 3)."""
    d_dot_n = pos_dot(rays_d, normals[:, None, :])
    inte = torch.sum(d_dot_n * rgbs, dim=1) * (4 * np.pi / rays_d.shape[1])
    return inte if allow_neg else torch.relu(inte)


def get_f0(metal, albedo):
    return 0.04 * (1.0 - metal) * torch.ones_like(albedo) + albedo * metal


def fresnel_schlick(F0, HdotV):
    return F0 + (1.0 - F0) * (1.0 - HdotV) ** 5


def fresnel_schlick_roughness(F0, NdotV, rough):
    return F0 + (torch.maximum((1.0 - rough).expand(F0.shape), F0)
                 - F0) * (1.0 - NdotV) ** 5


def geometry_schlick_ggx(NdotV, roughness):
    r = roughness + 1.0
    k = r * r / 8.0
    return NdotV / (NdotV * (1.0 - k) + k)


def geometry_blender(NdotV, roughness):
    a = roughness ** 2
    sqr = a * torch.clamp(1.0 / NdotV ** 2 - 1.0, min=0.0)
    return 0.5 * (torch.sqrt(1.0 + sqr) - 1.0)


# ---------------------------------------------------------------------------
# texture sampling (torch grid_sample semantics: align_corners=False, border)
# ---------------------------------------------------------------------------

def tex2d(tex, samples):
    """Bilinear sample. tex: (H, W, C); samples: (x, 2) in [-1, 1] as
    (x_coord -> W axis, y_coord -> H axis)."""
    H, W = tex.shape[:2]
    gx = ((samples[:, 0] + 1.0) * W - 1.0) / 2.0
    gy = ((samples[:, 1] + 1.0) * H - 1.0) / 2.0

    def fetch(iy, ix):
        return tex[torch.clamp(iy, 0, H - 1), torch.clamp(ix, 0, W - 1)]

    x0 = torch.floor(gx).to(torch.int32)
    y0 = torch.floor(gy).to(torch.int32)
    fx = (gx - x0)[:, None]
    fy = (gy - y0)[:, None]
    return ((1 - fx) * (1 - fy) * fetch(y0, x0)
            + fx * (1 - fy) * fetch(y0, x0 + 1)
            + (1 - fx) * fy * fetch(y0 + 1, x0)
            + fx * fy * fetch(y0 + 1, x0 + 1))


def tex3d(vol, samples):
    """Trilinear sample. vol: (D, H, W, C); samples: (x, 3) as
    (x->W, y->H, z->D) in [-1, 1]."""
    D, H, W = vol.shape[:3]
    gx = ((samples[:, 0] + 1.0) * W - 1.0) / 2.0
    gy = ((samples[:, 1] + 1.0) * H - 1.0) / 2.0
    gz = ((samples[:, 2] + 1.0) * D - 1.0) / 2.0

    def fetch(iz, iy, ix):
        return vol[torch.clamp(iz, 0, D - 1), torch.clamp(iy, 0, H - 1),
                   torch.clamp(ix, 0, W - 1)]

    x0 = torch.floor(gx).to(torch.int32)
    y0 = torch.floor(gy).to(torch.int32)
    z0 = torch.floor(gz).to(torch.int32)
    fx = (gx - x0)[:, None]
    fy = (gy - y0)[:, None]
    fz = (gz - z0)[:, None]
    out = 0.0
    for dz in (0, 1):
        wz = fz if dz else 1 - fz
        for dy in (0, 1):
            wy = fy if dy else 1 - fy
            for dx in (0, 1):
                wx = fx if dx else 1 - fx
                out = out + wz * wy * wx * fetch(z0 + dz, y0 + dy, x0 + dx)
    return out


# ---------------------------------------------------------------------------
# cubemaps
# ---------------------------------------------------------------------------

_BLUR_K = np.exp(-np.array([-1.0, 0.0, 1.0]) ** 2 / (2 * 0.8 ** 2))
_BLUR_K = _BLUR_K / _BLUR_K.sum()   # torchvision's sigma for k=3: 0.8


def _gaussian_blur_3x3(img):
    """Separable 3x3 gaussian with edge-clamped 'same' padding over the
    (H, W) axes of (..., H, W, C)."""
    k = torch.as_tensor(_BLUR_K, dtype=img.dtype, device=img.device)

    def along(im, axis):
        n = im.shape[axis]
        imp = torch.cat([im.narrow(axis, 0, 1), im,
                         im.narrow(axis, n - 1, 1)], dim=axis)
        out = 0.0
        for i in range(3):
            out = out + k[i] * imp.narrow(axis, i, n)
        return out

    return along(along(img, img.ndim - 3), img.ndim - 2)


def cubemap_blur(cubemap):
    """Blur each face of (6, r, r, 3)."""
    return _gaussian_blur_3x3(cubemap)


# face order [+z, -z, +x, -x, +y, -y]; axis -> first face of its pair
_AXIS_FACE = (2, 4, 0)                 # x->2/3, y->4/5, z->0/1
_AXIS_UV = ((1, 2), (0, 2), (0, 1))    # uv source components per major axis


def _cube_face_uv(ray_d):
    """Face selection + uv in [-1, 1] (reference render_utils.py:133-164)."""
    a = torch.abs(ray_d)
    major = torch.argmax(a, dim=-1)                        # (n,)
    max_ax = torch.gather(a, -1, major[:, None])
    d = ray_d / max_ax
    sign = torch.gather(ray_d, -1, major[:, None])[:, 0] < 0
    face = torch.as_tensor(_AXIS_FACE, device=ray_d.device)[major] \
        + sign.to(torch.int64)
    uv_idx = torch.as_tensor(_AXIS_UV, device=ray_d.device)[major]
    return face, torch.gather(d, -1, uv_idx)


def cubemap_sample(cubemap, ray_d, resolution, rough=None, blur_cm=True):
    """Sample a cubemap along directions, optionally through a
    roughness-indexed blur chain (reference render_utils.py:117-167).
    cubemap: (6*r*r, 3) or (6, r, r, 3); ray_d (n, 3); rough (n, 1) in
    [0, 1] selects among 5 progressively blurred mips."""
    cm = cubemap.reshape(6, resolution, resolution, 3)
    face, uv = _cube_face_uv(ray_d)
    uv_swapped = uv.flip(-1)   # the reference samples (v, u), reverseHW

    if rough is None:
        if blur_cm:
            cm = cubemap_blur(cubemap_blur(cm))
        tall = cm.reshape(6 * resolution, resolution, 3)
        H = resolution
        gy = ((uv_swapped[:, 1] + 1.0) * H - 1.0) / 2.0
        gy = torch.clamp(gy, 0.0, H - 1.0) + face.to(torch.float32) * H
        gx = ((uv_swapped[:, 0] + 1.0) * resolution - 1.0) / 2.0
        return _bilinear_rows(tall, gy, gx, H, face)

    mips = [cm]
    for _ in range(4):
        mips.append(cubemap_blur(mips[-1]))
    stack = torch.stack(mips, 0)                           # (5, 6, r, r, 3)
    level = torch.clamp(rough[:, 0], 0.0, 1.0) * 4.0
    l0 = torch.floor(level).to(torch.int64)
    fl = (level - l0)[:, None]
    lo = _sample_mip(stack, l0, face, uv_swapped, resolution)
    hi = _sample_mip(stack, torch.clamp(l0 + 1, max=4), face, uv_swapped,
                     resolution)
    return (1 - fl) * lo + fl * hi


def _bilinear_rows(tall, gy, gx, H, face):
    """Bilinear fetch from vertically stacked faces, the y interpolation
    clamped inside the selected face."""
    W = tall.shape[1]
    y0 = torch.floor(gy).to(torch.int64)
    x0 = torch.floor(gx).to(torch.int64)
    fy = (gy - y0)[:, None]
    fx = (gx - x0)[:, None]
    y_lo = face * H
    y_hi = y_lo + H - 1

    def fetch(iy, ix):
        return tall[torch.minimum(torch.maximum(iy, y_lo), y_hi),
                    torch.clamp(ix, 0, W - 1)]

    return ((1 - fx) * (1 - fy) * fetch(y0, x0)
            + fx * (1 - fy) * fetch(y0, x0 + 1)
            + (1 - fx) * fy * fetch(y0 + 1, x0)
            + fx * fy * fetch(y0 + 1, x0 + 1))


def _sample_mip(stack, lvl, face, uv, r):
    """stack: (5, 6, r, r, 3); per-ray (lvl, face) select + bilinear uv."""
    flat = stack.reshape(5 * 6 * r, r, 3)
    gy = torch.clamp(((uv[:, 1] + 1.0) * r - 1.0) / 2.0, 0.0, r - 1.0)
    gx = ((uv[:, 0] + 1.0) * r - 1.0) / 2.0
    row_face = lvl * 6 + face
    return _bilinear_rows(flat, gy + row_face.to(torch.float32) * r, gx, r,
                          row_face)


def cubemap2env_map(cubemap, cm_resol, H, W):
    """Lat-long env map from a cubemap (reference render_utils.py:173-189)."""
    dirs = latlong_dirs(H, W, device=cubemap.device).reshape(-1, 3)
    return cubemap_sample(cubemap, dirs, cm_resol, None,
                          False).reshape(H, W, 3)


def reflect_dir(normal, vdirs):
    return torch.sum(normal * vdirs, -1, keepdim=True) * normal * 2 - vdirs


def spec_shade(normal, vdirs, rough, kS, refl_probe):
    return kS * cubemap_sample(refl_probe, reflect_dir(normal, vdirs), 32,
                               rough)


def sh_glossy_shade(normal, vdirs, rough, model_brdf, embed_fn, sh9, F0):
    """Neural-BRDF glossy term: an MLP predicts two SH9 filter banks whose
    dots with the light SH give F0-scaled and additive specular colours
    (reference render_utils.py:199-210)."""
    spec = model_brdf(torch.cat([embed_fn(normal), embed_fn(vdirs), rough],
                                -1))                       # (x, 18)
    sh_num = sh9.shape[1]
    s1 = torch.sum(sh9 * spec[:, :sh_num, None], dim=1)
    s2 = torch.sum(sh9 * spec[:, sh_num:, None], dim=1)
    return F0 * s1 + s2


def sh_render_core(albedo, metal, rough, normal, vdirs, sh9, embed_fn,
                   model_brdf, clamp01, refl_probe=None, only_spec=False):
    """SH shading (reference render_utils.py:216-262): Lambertian through
    the closed-form SH irradiance, glossy through the neural BRDF or the
    prefiltered reflection probe (rough/smooth split as a select)."""
    F0 = get_f0(metal, albedo)
    vdirs = -vdirs  # camera-to-object -> object-to-camera

    NdotV = pos_dot(normal, vdirs)
    # stabilise grazing angles (reference :222-225)
    normal = torch.where(NdotV < 8e-2, normal + vdirs / 10, normal)
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)

    kS = fresnel_schlick_roughness(F0, NdotV, rough)
    kD = (1.0 - kS) * (1.0 - metal)
    diff_col = albedo / np.pi * sh9_irradiance(normal, sh9)

    if refl_probe is None:
        spec_col = sh_glossy_shade(normal, vdirs, rough, model_brdf,
                                   embed_fn, sh9, F0)
    elif only_spec:
        spec_col = spec_shade(normal, vdirs, rough, kS, refl_probe)
    else:
        rough_div = 0.2
        smooth = spec_shade(normal, vdirs, rough / rough_div, kS, refl_probe)
        glossy = sh_glossy_shade(normal, vdirs, rough, model_brdf,
                                 embed_fn, sh9, F0)
        spec_col = torch.where(rough < rough_div, smooth, glossy)

    radiance = kD * diff_col + spec_col
    return torch.clamp(radiance, 0.0, 1.0) if clamp01 \
        else torch.relu(radiance)


# ---------------------------------------------------------------------------
# spherical Gaussians
# ---------------------------------------------------------------------------

def sg_product(sg1, sg2):
    """The product of two SGs is an SG (reference render_utils.py:266-276).
    sg: (..., 7)."""
    lm = sg1[..., 3:4] + sg2[..., 3:4]
    um = (sg1[..., 3:4] * sg1[..., :3] + sg2[..., 3:4] * sg2[..., :3]) / lm
    um_len = torch.linalg.norm(um, dim=-1, keepdim=True)
    mu = sg1[..., -3:] * sg2[..., -3:] * torch.exp(lm * (um_len - 1.0))
    return torch.cat([um / um_len, lm * um_len, mu], dim=-1)


def sg_hemisphere_integral(sgs, normal):
    """Analytic SG integral over the hemisphere about `normal` (reference
    render_utils.py:280-300)."""
    cos_beta = torch.sum(sgs[..., :3] * normal, -1, keepdim=True)
    lam = torch.clamp(sgs[..., 3:4], min=EPS)
    inv_lam = 1.0 / lam
    t = torch.sqrt(lam) * (1.6988 + 10.8438 * inv_lam) / (
        1.0 + 6.2201 * inv_lam + 10.2415 * inv_lam * inv_lam)
    inv_a = torch.exp(-t)
    mask = (cos_beta >= 0).to(sgs.dtype)
    inv_b = torch.exp(-t * torch.clamp(cos_beta, min=0.0))
    s1 = (1.0 - inv_a * inv_b) / (1.0 - inv_a + inv_b - inv_a * inv_b)
    b = torch.exp(t * torch.clamp(cos_beta, max=0.0))
    s2 = (b - inv_a) / ((1.0 - inv_a) * (b + 1.0))
    s = mask * s1 + (1.0 - mask) * s2
    A_b = 2.0 * np.pi / lam * (torch.exp(-lam) - torch.exp(-2.0 * lam))
    A_u = 2.0 * np.pi / lam * (1.0 - torch.exp(-lam))
    return (A_b * (1.0 - s) + A_u * s) * sgs[..., -3:]


def sg_irradiance(sgs, normal, sum_lights=True):
    """Cosine-weighted irradiance through the SG-times-cosine-SG product
    (reference render_utils.py:304-317). sgs (px, lx, 7); normal (px, 3)."""
    px = normal.shape[0]
    cos_sg = torch.cat([normal, normal.new_full((px, 1), 0.0315),
                        normal.new_full((px, 3), 32.7080)], -1)
    cos_sg = cos_sg[:, None, :].expand(sgs.shape)
    n = normal[:, None, :].expand(*sgs.shape[:2], 3)
    irr = sg_hemisphere_integral(sg_product(sgs, cos_sg), n) \
        - 31.7003 * sg_hemisphere_integral(sgs, n)
    if sum_lights:
        irr = torch.sum(irr, dim=1)
    return torch.relu(irr)


def sg_render_core(albedo, metal, rough, normal, vdirs, l_sgs, clamp01,
                   self_shadow=True, refl_probe=None, only_spec=False):
    """SG shading (reference render_utils.py:321-375): the GGX NDF warped to
    an SG about the reflection direction, multiplied with the light SGs and
    integrated analytically. l_sgs: (px, lx, 7) per-point (self-shadow
    decayed) lights or (lx, 7) shared ones."""
    vdirs = -vdirs
    normal = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    px = normal.shape[0]
    m2 = rough ** 2
    d_lam = 2.0 / m2 / (4.0 * pos_dot_eps(normal, vdirs))
    d_mu = (1.0 / (np.pi * m2)).expand(px, 3)
    D_sg = torch.cat([reflect_dir(normal, vdirs), d_lam, d_mu], -1)

    if l_sgs.ndim == 2:
        l_sgs = l_sgs[None].expand(px, *l_sgs.shape)
    ld = sg_product(D_sg[:, None, :].expand(l_sgs.shape), l_sgs)
    spec_irr = sg_irradiance(ld, normal)
    diff_irr = sg_irradiance(l_sgs, normal)

    NdotV = pos_dot(normal, vdirs)
    NdotL = NdotV
    F0 = get_f0(metal, albedo)
    G = 1.0 / (geometry_blender(NdotV, rough) * 2.0 + 1.0)
    Moi = fresnel_schlick(F0, NdotV) * G / (4.0 * NdotL * NdotV + EPS)

    kS = fresnel_schlick_roughness(F0, NdotV, rough)
    kD = (1.0 - kS) * (1.0 - metal)
    radiance = kD * (albedo / np.pi * diff_irr) + Moi * spec_irr
    return torch.clamp(radiance, 0.0, 1.0) if clamp01 \
        else torch.relu(radiance)
