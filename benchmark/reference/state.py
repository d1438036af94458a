"""The program's state handed to the reference: the same tree rebuilt from
the reference's own classes, every tensor a copy, so the reference's step
runs no method of the program's classes and cannot write into its state."""

import dataclasses
import functools
import importlib

import torch

# the state's classes and their modules, the same in every reference package
MODULES = {"CoupledState": "models.coupled.driver", "DycoreState": "models.dycore.state",
           "AeroState": "models.partmc.aero_state", "BulkOptics": "models.partmc.optics",
           "LandState": "models.physics.lsm", "NoahState": "models.physics.lsm"}


@functools.cache
def classes(root: str) -> dict:
    """``{name: class}`` of :data:`MODULES` in the reference package ``root``
    (``benchmark.reference.<package>``)."""
    return {name: getattr(importlib.import_module(f"{root}.{mod}"), name)
            for name, mod in MODULES.items()}


def adopt(obj, device, root: str):
    """``obj`` (a tree of the program's dataclasses, dicts and tensors) in
    the classes of the reference package ``root``, its tensors copied (onto
    ``device``, or where they are where it is None)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device=device if device is not None else obj.device,
                               copy=True)
    if dataclasses.is_dataclass(obj):
        cls = classes(root)[type(obj).__name__]
        return cls(**{f.name: adopt(getattr(obj, f.name), device, root)
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: adopt(v, device, root) for k, v in obj.items()}
    return obj
