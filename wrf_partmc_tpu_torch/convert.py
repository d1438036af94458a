"""State carried between the JAX package and the port.

``from_numpy`` turns the JAX package's dataclasses (``CoupledState``,
``DycoreState``, ``AeroState``, ``Grid``, ``AeroData``, ``Scenario``,
``AeroDist``, ``OutflowProbs``, ``EnvState``, ``GasData``, ``NoahState``,
``LandState``, ``BdyData``, ``BulkOptics``, ``BinGrid``,
``AeroDiagnostics``, ...) into the port's
counterparts, matching classes by name and fields by name.  The input is
any object with the JAX field names holding numpy arrays (for example
``jax.tree.map(np.asarray, state)``); nothing here imports jax.
``to_numpy`` returns the port's dataclasses with numpy leaves.
``config_from_reference`` rebuilds the port's ``Config`` from the JAX
package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Config
from .grid import Grid
from .models.coupled.bdy import BdyData
from .models.coupled.driver import CoupledState
from .models.dycore.solve import StepDiag
from .models.dycore.state import DycoreState
from .models.partmc.aero_data import AeroData
from .models.partmc.aero_state import AeroState
from .models.partmc.bin_grid import BinGrid
from .models.partmc.diagnostics import AeroDiagnostics
from .models.partmc.dist import AeroDist
from .models.partmc.env_state import EnvState
from .models.partmc.gas_data import GasData
from .models.partmc.optics import BulkOptics
from .models.partmc.scenario import Scenario
from .models.physics.lsm import LandState, NoahState
from .ops.advection import OutflowProbs
from .utils.tree import tree_map

_CLASSES = {cls.__name__: cls for cls in (
    CoupledState, DycoreState, AeroState, Grid, AeroData, AeroDist, EnvState,
    GasData, Scenario, OutflowProbs, StepDiag, NoahState, LandState, BdyData,
    BulkOptics, BinGrid, AeroDiagnostics)}

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}
_KEEP = (np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.bool_))


def _leaf(a, device):
    """float32/int32/bool arrays as tensors; 64-bit arrays narrowed so no
    float64 table reaches the port."""
    arr = np.asarray(a)
    if arr.dtype in _NARROW:
        arr = arr.astype(_NARROW[arr.dtype])
    elif arr.dtype not in _KEEP:
        raise TypeError(f"from_numpy: unsupported dtype {arr.dtype}")
    return torch.tensor(arr, device=device)


def from_numpy(tree, device="cpu"):
    """The port's counterpart of a JAX-package object with numpy leaves."""
    if tree is None or isinstance(tree, (str, int, float, bool)):
        return tree
    if isinstance(tree, (np.ndarray, np.generic)):
        return _leaf(tree, device)
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy(v, device) for v in tree)
    name = type(tree).__name__
    if name not in _CLASSES:
        raise TypeError(f"from_numpy: no port counterpart for {name}")
    cls = _CLASSES[name]
    ours = {f.name for f in dataclasses.fields(cls)}
    for f in dataclasses.fields(tree):
        if f.name not in ours and getattr(tree, f.name) is not None:
            raise NotImplementedError(f"from_numpy: {name}.{f.name} is not ported")
    kw = {}
    for f in dataclasses.fields(cls):
        if not hasattr(tree, f.name) and f.default is not dataclasses.MISSING:
            continue                 # a port-only field (a Grid's decomposition)
        v = getattr(tree, f.name)
        if name == "CoupledState" and f.name == "step":
            kw[f.name] = int(np.asarray(v))
        else:
            kw[f.name] = from_numpy(v, device)
    return cls(**kw)


def to_numpy(tree):
    """The port's dataclasses with every tensor leaf as a numpy array."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def config_from_reference(ref, cls=Config):
    """The port's ``cls`` (a ``Config`` by default) with the values of
    ``ref``, any dataclass tree with the same field names (the JAX
    package's ``Config``); nested groups are rebuilt as the port's own
    classes.  Raises if either tree has a field the other lacks."""
    ours = {f.name for f in dataclasses.fields(cls)}
    theirs = {f.name for f in dataclasses.fields(ref)}
    if ours != theirs:
        raise ValueError(f"config_from_reference: {cls.__name__} fields differ: "
                         f"port only {sorted(ours - theirs)}, reference only "
                         f"{sorted(theirs - ours)}")
    default = cls()
    kw = {}
    for name in ours:
        v = getattr(ref, name)
        if dataclasses.is_dataclass(v):
            v = config_from_reference(v, type(getattr(default, name)))
        kw[name] = v
    return cls(**kw)
