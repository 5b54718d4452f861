"""The program's coupling stack, built through its public classes from the
weights the benchmark made, and the weights' leaves in the program's
parameter order."""
from __future__ import annotations

import enflows_tpu_torch as et

# The configuration's ``products``: the conditioners' compute dtype in the
# program (None: its default, TF32 products in B4/B5).
PRODUCTS = {"tf32": None, "bf16": "bfloat16"}


def leaves(weights) -> list:
    """[coupling][layer] (W, b) -> flat list, coupling by coupling, W then b
    of each layer: the order of the program's ``parameters()``."""
    return [t for layers in weights for W_b in layers for t in W_b]


def nest(flat: list, cfg: dict) -> list:
    """The inverse of ``leaves``: [coupling][layer] (W, b) from the flat
    list, each coupling's conditioner ``len(cfg["hidden"]) + 1`` layers."""
    per = 2 * (len(cfg["hidden"]) + 1)
    return [[(flat[i + j], flat[i + j + 1]) for j in range(0, per, 2)]
            for i in range(0, len(flat), per)]


def port_stack(cfg: dict, weights, control: bool = False):
    """The stack as the program holds it: couplings with reversal Permutes
    between them, each conditioner an ``MLPConditioner`` over copies of the
    given weights, in the configuration's ``products``. ``control`` gives
    every conditioner bf16 products, the precision below TF32."""
    if control and cfg["products"] != "tf32":
        raise ValueError("the bf16 control stands below TF32 products only")
    compute = "bfloat16" if control else PRODUCTS[cfg["products"]]
    dim = cfg["dim"]
    split = dim // 2
    stages = []
    for i, layers in enumerate(weights):
        if i:
            stages.append(et.Permute(tuple(range(dim - 1, -1, -1))))
        cond = et.MLPConditioner(
            [(W.clone(), b.clone()) for W, b in layers],
            activation=cfg["activation"],
            compute_dtype=compute)
        if cfg["coupling"] == "affine":
            stages.append(et.AffineCoupling(
                cond, split, max_log_scale=cfg["max_log_scale"]))
        else:
            stages.append(et.RQSplineCoupling(
                cond, split, n_bins=cfg["n_bins"], bound=cfg["bound"]))
    flow = et.Chain.of(*stages)
    got = [tuple(p.shape) for p in flow.parameters()]
    want = [tuple(t.shape) for t in leaves(weights)]
    if got != want:
        raise RuntimeError(f"the program's parameters {got} do not match the "
                           f"benchmark's weights {want}")
    return flow
