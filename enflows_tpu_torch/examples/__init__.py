"""Example scripts of the port, counterparts of the repository's
``examples/`` (each runs on the card unless asked for the CPU)."""
from __future__ import annotations

import torch


def example_device(cpu: bool) -> torch.device:
    """The CPU when ``cpu``, else the current CUDA card; with no card and no
    ``--cpu``, a ``RuntimeError`` (an example never falls back)."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is "
                           "False); pass --cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def generator(device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded ``seed``: the port's
    counterpart of the JAX scripts' ``PRNGKey(seed)``."""
    return torch.Generator(device=device).manual_seed(seed)
