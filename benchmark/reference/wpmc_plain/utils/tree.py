"""Small helpers over the port's frozen dataclasses of tensors.

The JAX package registers its state dataclasses as pytrees; the port keeps
the same classes as plain frozen dataclasses and walks them with these
helpers (device moves, conversion to and from numpy, module buffers).
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, obj):
    """Apply ``fn`` to every tensor leaf of nested dataclasses, dicts, lists
    and tuples; other leaves (ints, floats, strings, None) pass through."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_map(fn, v) for v in obj)
    return obj


def _children(obj):
    """(name, child) pairs of a dataclass's fields or a dict's items."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]
    if isinstance(obj, dict):
        return list(obj.items())
    return []


def tensor_leaves(obj, prefix: str) -> dict:
    """Flat ``{name: tensor}`` of the tensor leaves of nested dataclasses
    and dicts (names joined with ``__`` so they are valid buffer names)."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    out = {}
    for name, child in _children(obj):
        out.update(tensor_leaves(child, f"{prefix}__{name}"))
    return out


def with_leaves(obj, prefix: str, leaves: dict):
    """Inverse of :func:`tensor_leaves`: ``obj`` with every tensor leaf
    replaced by ``leaves[name]``."""
    if isinstance(obj, torch.Tensor):
        return leaves[prefix]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: with_leaves(getattr(obj, f.name), f"{prefix}__{f.name}",
                                leaves)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: with_leaves(v, f"{prefix}__{k}", leaves) for k, v in obj.items()}
    return obj
