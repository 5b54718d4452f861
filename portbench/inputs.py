"""What the benchmark makes from ``--seed`` and hands to both sides: the data
set, the initial conditioner weights and the base draws.

Everything is made on the run's device in a few large calls from
``torch.Generator`` s seeded from the run's seed, so one seed gives the same
inputs on every run. Nothing here imports the program: the program receives
copies of these tensors, and the reference works from them again.
"""
from __future__ import annotations

import math

import torch

# Each stream of draws has a generator of its own, so adding draws to one
# stream does not move another.
STREAMS = {"weights": 1, "data": 2, "base": 3, "sampler": 4, "pick": 5}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of the run's draws (any whole seed)."""
    return (int(seed) * 1_000_003 + STREAMS[stream]) % (1 << 63)


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def conditioner_sizes(cfg: dict) -> list[int]:
    """Widths of one coupling's conditioner, input to output: the untouched
    half, the hidden widths, and the parameters of the transformed half (2
    a lane affine, 3K - 1 a lane spline)."""
    d_a = cfg["dim"] // 2
    d_b = cfg["dim"] - d_a
    per_lane = 2 if cfg["coupling"] == "affine" else 3 * cfg["n_bins"] - 1
    return [d_a, *cfg["hidden"], d_b * per_lane]


def initial_weights(cfg: dict, seed: int, device) -> list[list[tuple]]:
    """[coupling][layer] -> (W (fan_in, fan_out), b (fan_out,)), float32.

    He-normal hidden layers with zero biases; the last layer, which an
    identity-initialized coupling holds at zero, is ``last_layer_perturbation``
    x N(0, 1) in W and b. All the normals come from one call."""
    sizes = conditioner_sizes(cfg)
    shapes = [(k, n) for k, n in zip(sizes[:-1], sizes[1:])]
    per = sum(k * n + n for k, n in shapes)
    g = generator(seed, "weights", device)
    draws = torch.randn(cfg["n_layers"] * per, generator=g, device=device,
                        dtype=torch.float32)
    eps = cfg["last_layer_perturbation"]
    out, at = [], 0
    for _ in range(cfg["n_layers"]):
        layers = []
        for i, (k, n) in enumerate(shapes):
            W = draws[at:at + k * n].view(k, n)
            b = draws[at + k * n:at + k * n + n]
            at += k * n + n
            if i + 1 < len(shapes):
                layers.append((W * math.sqrt(2.0 / k), torch.zeros_like(b)))
            else:
                layers.append((eps * W, eps * b))
        out.append(layers)
    return out


def dataset(cfg: dict, traffic: dict, seed: int, device,
            block: int = 1 << 21) -> torch.Tensor:
    """(rows, dim) correlated non-Gaussian float32 data: u = z A^T with
    A = I + s randn / sqrt(d), through the warp lam sinh(u / delta), made in
    blocks so that no (rows, dim) temporary is held beside it."""
    d = cfg["dim"]
    p = traffic["data"]
    g = generator(seed, "data", device)
    A = torch.eye(d, device=device) + p["mix_scale"] * torch.randn(
        d, d, generator=g, device=device) / math.sqrt(d)
    rows = traffic["dataset_rows"]
    X = torch.empty(rows, d, device=device)
    with torch.no_grad():
        for r0 in range(0, rows, block):
            r1 = min(rows, r0 + block)
            z = torch.randn(r1 - r0, d, generator=g, device=device)
            X[r0:r1] = p["warp_lambda"] * torch.sinh(
                (z @ A.T) / p["warp_delta"])
    return X


def base_draws(rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """(rows, dim) standard normals: the base points a sampler's chains
    start from, pushed through the transport."""
    g = generator(seed, "base", device)
    return torch.randn(rows, dim, generator=g, device=device)
