"""Closed-form ray-step lattice (port of arnerf_tpu/ops/stepping.py).

The reference marches each ray serially, t += calc_dt(t); that recurrence
has a closed form, so every candidate t(k) of a ray is computed in
parallel:
  phase 1 (dt pinned at dt_min):      t(k) = t1 + k*dt_min          while t < A
  phase 2 (exponential, dt = t*f):    t(k) = t_A * (1+f)^(k - k_A)  while t < B
  phase 3 (dt pinned at dt_max):      t(k) = B + (k - k_B)*dt_max
where A = dt_min/f, B = dt_max/f. For exp_step_factor == 0 the lattice is
uniform: t(k) = t1 + k*dt_min.

`fma` rounds a*b + c once, as XLA does when it contracts the lattice and
position products into fused multiply-adds; the occupancy test is
discontinuous in these values, so the port rounds them the same way.
"""

import math

import torch

SQRT3 = 1.7320508075688772


def _f64(x):
    return x.double() if torch.is_tensor(x) else float(x)


def fma(a, b, c):
    """a*b + c of float32 values, rounded once to float32.

    The product of two float32 values is exact in float64, so only the sum
    rounds before the final cast. Python floats must already hold float32
    values (see `f32`)."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def f32(x: float) -> float:
    """A Python float rounded to the nearest float32, as JAX rounds a weakly
    typed constant that meets a float32 array."""
    return float(torch.tensor(x, dtype=torch.float32))


def calc_dt(t, exp_step_factor: float, max_samples: int, grid_size: int,
            scale: float):
    """reference: models/csrc/raymarching.cu:11-13."""
    dt_min = SQRT3 / max_samples
    dt_max = SQRT3 * 2 * scale / grid_size
    return torch.clamp(t * exp_step_factor, dt_min, dt_max)


def mip_from_pos(xyz, cascades: int):
    """Cascade from position magnitude: |x| in [0,.5)->0, [.5,1)->1, [1,2)->2...

    reference: models/csrc/raymarching.cu:19-23 (frexp-based).
    """
    mx = torch.amax(torch.abs(xyz), dim=-1)
    e = torch.floor(torch.log2(torch.clamp(mx, min=1e-12)))
    return torch.clamp(e + 2, 0, cascades - 1).to(torch.int64)


def mip_from_dt(dt, grid_size: int, cascades: int):
    """Cascade from step size: dt in [0,1/G)->0, [1/G,2/G)->1, ...

    reference: models/csrc/raymarching.cu:29-32.
    """
    e = torch.floor(torch.log2(torch.clamp(dt * grid_size, min=1e-12)))
    return torch.clamp(e + 1, 0, cascades - 1).to(torch.int64)


def lattice_t(t1, k, exp_step_factor: float, max_samples: int,
              grid_size: int, scale: float):
    """t(k) of the step lattice anchored at t1. t1: (...,) k: broadcastable."""
    dt_min = SQRT3 / max_samples
    dt_max = SQRT3 * 2 * scale / grid_size
    # calc_dt's clip(t*f, dt_min, dt_max) resolves to min(dt_min, dt_max)
    # whenever dt_min > dt_max: use the same effective uniform step
    dt_min = min(dt_min, dt_max)
    k = k.to(torch.float32)
    if exp_step_factor == 0.0:
        return fma(k, f32(dt_min), t1)
    f = exp_step_factor
    A = dt_min / f
    B = dt_max / f
    log1pf = math.log1p(f)
    # number of dt_min steps before the exponential phase begins
    k_A = torch.clamp((A - t1) / dt_min, min=0.0)
    t_A = torch.clamp(t1, A, B)  # t at the start of the exponential phase
    # number of exponential steps before dt saturates at dt_max
    k_B = k_A + torch.clamp(
        torch.log(B / torch.clamp(t_A, min=1e-12)) / log1pf, min=0.0)
    t_lin = fma(k, f32(dt_min), t1)
    t_exp = t_A * torch.exp((k - k_A) * log1pf)
    t_sat = fma(k - k_B, f32(dt_max), f32(B))
    return torch.where(k <= k_A, t_lin, torch.where(k <= k_B, t_exp, t_sat))


def num_lattice_steps(t_min: float, t_max: float, exp_step_factor: float,
                      max_samples: int, grid_size: int, scale: float) -> int:
    """Static K needed so the lattice anchored at any t1 >= t_min covers t_max."""
    dt_min = SQRT3 / max_samples
    dt_max = SQRT3 * 2 * scale / grid_size
    dt_min = min(dt_min, dt_max)  # same effective step as lattice_t/calc_dt
    if exp_step_factor == 0.0:
        return int(math.ceil((t_max - t_min) / dt_min)) + 1
    f = exp_step_factor
    A = dt_min / f
    B = dt_max / f
    k = max(0.0, (A - t_min) / dt_min)
    t = max(t_min, A)
    if t_max > t:
        k += max(0.0, math.log(min(t_max, B) / t) / math.log1p(f))
    if t_max > B:
        k += (t_max - B) / dt_max
    return int(math.ceil(k)) + 1
