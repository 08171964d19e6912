from .ngp import (
    NGPConfig, ngp_init, ngp_density, ngp_forward, ngp_forward_chunked,
    ngp_log_radiance_to_rgb, GridState, grid_state_init,
)
