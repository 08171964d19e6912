"""Seeded weights of an Instant-NGP model, made on the device in one call a
leaf: the table uniform in [-1e-4, 1e-4] (tiny-cuda-nn's initialisation)
and each bias-free MLP layer uniform in +-sqrt(6 / fan_in).

A view of an initialised field says little of a viewer's work: its density
is about exp(0) = 1 everywhere, so no ray ends before its sample budget.
`trained` gives the magnitudes of a trained field instead: the table
uniform in +-trained["table"], and the density output's column of the
first MLP made non-negative and scaled by trained["density_gain"]. The
MLPs have no biases, so this is what makes every point opaque: sigma =
exp(h0) with h0 a sum of non-negative terms, a few hundred at the median.
Rays then end within a few samples of their first occupied cell, as they
do at a trained scene's surface."""

import math

import torch

from .field import Grid


def make(cfg: dict, seed: int, device, trained: dict = None) -> dict:
    """{"hash_table", "sigma_mlp": [W0, W1], "rgb_mlp": [V0, V1, V2]} of
    configuration `cfg` from `seed`, on `device`; at a trained field's
    magnitudes where `trained` is given (the module's docstring)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    grid = Grid(cfg["scale"], cfg["n_levels"], cfg["n_features"],
                cfg["log2_hashmap_size"], cfg["base_resolution"])

    def uniform(shape, bound):
        u = torch.rand(shape, generator=gen, device=device)
        return u * (2 * bound) - bound

    def layers(dims):
        return [uniform((a, b), math.sqrt(6.0 / a))
                for a, b in zip(dims[:-1], dims[1:])]

    enc = cfg["n_levels"] * cfg["n_features"]
    h, so, rh = cfg["sigma_hidden"], cfg["sigma_out"], cfg["rgb_hidden"]
    table_bound = trained["table"] if trained else 1e-4
    params = {"hash_table": uniform((grid.rows, cfg["n_features"]),
                                    table_bound),
              "sigma_mlp": layers([enc, h, so]),
              "rgb_mlp": layers([16 + so, rh, rh, 3])}
    if trained:
        w1 = params["sigma_mlp"][1]
        w1[:, 0] = torch.abs(w1[:, 0]) * trained["density_gain"]
    return params
