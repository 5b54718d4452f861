"""Walking nested state: the port's stand-in for JAX's pytree leaves.

The port's bijectors are ``nn.Module`` s, so ``pytree_dataclass`` has no
counterpart; what remains is reading the leaves of a module, a tensor or a
nested dict, list or tuple of them.
"""
from __future__ import annotations

import functools

import torch
from torch import nn


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in order: a module gives its parameters, then
    its buffers; a dict its values; a list or tuple its items; anything
    else (a tensor, a number, None) is a leaf."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return [tree]
    return [leaf for item in tree for leaf in tree_leaves(item)]


def param_dtype(tree) -> torch.dtype:
    """The promoted dtype of the floating tensors (parameters and buffers of
    a module) in ``tree``, ``torch.float32`` when there are none
    (``enflows_tpu/utils/pytree.py:110-122``)."""
    dtypes = [leaf.dtype for leaf in tree_leaves(tree)
              if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    if not dtypes:
        return torch.float32
    return functools.reduce(torch.promote_types, dtypes)
