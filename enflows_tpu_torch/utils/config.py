"""Typed run configs: TOML/JSON files with ``--section.key=value``
overrides, and the flow they describe.

PyTorch counterpart of ``enflows_tpu/utils/config.py``: the same
dataclasses, fields and defaults, so that one config file drives either
package's CLI. ``build_flow`` builds the port's bijectors on a device;
its random initializers draw from a ``torch.Generator`` seeded 0, so their
weights differ from the JAX package's (carry them across with
``interop.from_jax`` to compare). ``MeshConfig.axes`` other than ``{}``
builds a ``parallel`` mesh over the ranks (``mesh_from_config``).
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
import json
import os
import sys
import tomllib
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch


@dataclass
class FlowConfig:
    """Flow architecture: stage kinds in data-flow order."""
    dim: int = 1
    stages: list[str] = field(default_factory=lambda: [
        "center_stretch_inv", "johnson", "center_stretch_inv", "johnson"])
    householder_reflections: int = 2
    coupling_hidden: list[int] = field(default_factory=lambda: [32, 32])
    coupling_bins: int = 8           # spline_coupling stages
    dtype: str = "float32"


@dataclass
class TrainConfig:
    objective: str = "whitening"     # whitening | elbo
    optimizer: str = "adagrad"
    learning_rate: float = 0.1
    nbatches: int = 100
    nepochs: int = 10
    batch_size: int = 100            # ELBO path
    nsteps: int = 1000               # ELBO path
    antithetic: bool = True
    stl: bool = False                # sticking-the-landing VI gradients
    checkpoint_every: Optional[int] = None  # preemption-safe chunks
    seed: int = 0


@dataclass
class SamplerConfig:
    algorithm: str = "nuts"          # nuts | hmc | chees | smc
    num_chains: int = 8
    num_warmup: int = 500
    num_samples: int = 1000
    max_depth: int = 10
    num_steps: int = 32              # hmc
    target_accept: float = 0.8
    num_particles: int = 8192        # smc
    mutation_steps: int = 5
    ess_target: float = 0.5
    # infer() transport family: auto | elementwise | affine | spline
    precondition_kind: str = "auto"
    seed: int = 0


@dataclass
class MeshConfig:
    axes: dict[str, int] = field(default_factory=dict)  # {} = one device
    axis_name: str = "chains"


@dataclass
class RunConfig:
    flow: FlowConfig = field(default_factory=FlowConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    checkpoint_dir: Optional[str] = None
    metrics_path: Optional[str] = None
    # ``target``: a "module:attr" / "path/to/file.py:attr" spec of a
    # per-sample log density (dim,) -> scalar for sample/infer;
    # ``data_path``: an .npz/.npy array (n, dim) for train's whitening.
    target: Optional[str] = None
    data_path: Optional[str] = None


def _coerce(dc_cls, data: dict):
    return dc_cls(**{f.name: data[f.name] for f in dataclasses.fields(dc_cls)
                     if f.name in data})


def load_config(path: Optional[str] = None,
                overrides: Optional[list[str]] = None) -> RunConfig:
    """A ``RunConfig`` from a TOML (``.toml``) or JSON file and
    ``section.key=value`` overrides, whose values parse as JSON where they
    can and stay strings otherwise
    (``enflows_tpu/utils/config.py:103-143``)."""
    data: dict[str, Any] = {}
    if path:
        if path.endswith(".toml"):
            with open(path, "rb") as f:
                data = tomllib.load(f)
        else:
            with open(path) as f:
                data = json.load(f)
    cfg = RunConfig(
        flow=_coerce(FlowConfig, data.get("flow", {})),
        train=_coerce(TrainConfig, data.get("train", {})),
        sampler=_coerce(SamplerConfig, data.get("sampler", {})),
        mesh=_coerce(MeshConfig, data.get("mesh", {})),
        checkpoint_dir=data.get("checkpoint_dir"),
        metrics_path=data.get("metrics_path"),
        target=data.get("target"), data_path=data.get("data_path"))
    for ov in overrides or []:
        key, eq, raw = ov.partition("=")
        if not eq:
            raise ValueError(f"override must be key=value: {ov}")
        parts = key.strip().lstrip("-").split(".")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        obj = cfg
        for p in parts[:-1]:
            if not hasattr(obj, p):
                raise ValueError(f"unknown config key: {key}")
            obj = getattr(obj, p)
        if not hasattr(obj, parts[-1]):
            raise ValueError(f"unknown config key: {key}")
        setattr(obj, parts[-1], val)
    return cfg


def mesh_from_config(cfg: RunConfig, device=None):
    """The mesh ``cfg.mesh`` describes (``enflows_tpu/cli.py:17-21``), or
    None for ``axes = {}``: ``parallel.make_mesh(axes,
    axis_name=cfg.mesh.axis_name)`` over the process group, joined first
    from ``torchrun``'s environment if it is not up (NCCL on a card, gloo
    for a CPU ``device``)."""
    if not cfg.mesh.axes:
        return None
    from ..parallel import distributed_init, make_mesh
    cpu = device is not None and torch.device(device).type == "cpu"
    distributed_init(backend="gloo" if cpu else None)
    return make_mesh(dict(cfg.mesh.axes), axis_name=cfg.mesh.axis_name,
                     device=device)


def resolve_target(spec: str):
    """The callable that the importlib-style ``spec`` names
    (``enflows_tpu/utils/config.py:146-183``): ``module:attr`` (the current
    working directory is put on ``sys.path``, so local modules import) or
    ``path/to/file.py:attr`` (loaded from the file); ``attr`` may be
    dotted. For the CLI it is a per-sample log density, (dim,) -> scalar,
    written in torch."""
    mod_s, sep, attr = spec.partition(":")
    if not sep or not attr:
        raise ValueError(
            f"target spec must be 'module:attr' or 'file.py:attr', got "
            f"{spec!r}")
    if mod_s.endswith(".py") or os.sep in mod_s:
        name = os.path.splitext(os.path.basename(mod_s))[0]
        file_spec = importlib.util.spec_from_file_location(name, mod_s)
        if file_spec is None or file_spec.loader is None:
            raise ImportError(f"cannot load module from {mod_s!r}")
        mod = importlib.util.module_from_spec(file_spec)
        file_spec.loader.exec_module(mod)
    else:
        cwd = os.getcwd()
        if cwd not in sys.path:
            sys.path.insert(0, cwd)
        mod = importlib.import_module(mod_s)
    fn = functools.reduce(getattr, attr.split("."), mod)
    if not callable(fn):
        raise TypeError(f"{spec!r} resolved to non-callable {type(fn)}")
    return fn


def load_array(path: str) -> np.ndarray:
    """A training-data array from .npz (key 'X' or 'data', else the first
    array) or .npy (``enflows_tpu/utils/config.py:186-197``)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            for key in ("X", "data"):
                if key in z:
                    return np.asarray(z[key])
            return np.asarray(z[z.files[0]])
    return np.asarray(np.load(path))


def build_flow(cfg: FlowConfig, device="cuda"):
    """The configured flow on ``device`` (the card unless the caller asks
    for the CPU), identity-ish initialized as the JAX package does
    (``enflows_tpu/utils/config.py:200-245``). Householder rows and coupling
    weights draw, in stage order, from a ``torch.Generator`` seeded 0 on
    ``device``."""
    from ..bijectors import (CenterStretch, Chain, Householder, Johnson,
                             Permute, ScaleShift, init_affine_coupling,
                             init_rq_spline_coupling, invert)

    dtype = getattr(torch, cfg.dtype)
    d = cfg.dim
    vec = lambda v: torch.full((d,), v, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    stages = []
    for kind in cfg.stages:
        if kind == "johnson":
            stages.append(Johnson(vec(0.0), vec(5.0), vec(0.0), vec(5.0)))
        elif kind == "center_stretch_inv":
            stages.append(invert(CenterStretch(vec(0.0), vec(1.0),
                                               vec(0.0))))
        elif kind == "center_stretch":
            stages.append(CenterStretch(vec(0.0), vec(1.0), vec(0.0)))
        elif kind == "scale_shift":
            stages.append(ScaleShift(vec(1.0), vec(0.0)))
        elif kind == "householder":
            V = torch.randn(cfg.householder_reflections, d, generator=gen,
                            dtype=dtype, device=device)
            stages.append(Householder(V).canonicalize())
        elif kind == "coupling":
            stages.append(init_affine_coupling(
                gen, d, tuple(cfg.coupling_hidden), dtype=dtype,
                device=device))
        elif kind == "spline_coupling":
            stages.append(init_rq_spline_coupling(
                gen, d, tuple(cfg.coupling_hidden), n_bins=cfg.coupling_bins,
                dtype=dtype, device=device))
        elif kind == "reverse":
            stages.append(Permute(tuple(range(d - 1, -1, -1))))
        else:
            raise ValueError(f"unknown stage kind: {kind}")
    return Chain.of(*stages)
