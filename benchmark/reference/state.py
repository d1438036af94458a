"""The program's state handed to the reference: the same tree rebuilt from
the reference's own classes, every tensor a copy, so the reference's step
runs no method of the program's classes and cannot write into its state."""

import dataclasses

import torch

from benchmark.reference.wpmc_plain.models.coupled.driver import CoupledState
from benchmark.reference.wpmc_plain.models.dycore.state import DycoreState
from benchmark.reference.wpmc_plain.models.partmc.aero_state import AeroState
from benchmark.reference.wpmc_plain.models.partmc.optics import BulkOptics
from benchmark.reference.wpmc_plain.models.physics.lsm import LandState, NoahState

CLASSES = {c.__name__: c for c in (CoupledState, DycoreState, AeroState, LandState,
                                   NoahState, BulkOptics)}


def adopt(obj, device=None):
    """``obj`` (a tree of the program's dataclasses, dicts and tensors) in
    the reference's classes, its tensors copied (onto ``device``)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device=device if device is not None else obj.device,
                               copy=True)
    if dataclasses.is_dataclass(obj):
        cls = CLASSES[type(obj).__name__]
        return cls(**{f.name: adopt(getattr(obj, f.name), device)
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: adopt(v, device) for k, v in obj.items()}
    return obj
