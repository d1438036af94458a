"""The numbers that decide ``correct``: the program's output against the
plain reference's.

The reference follows the program one step: from the state the window's
last step started from (the program's own), it computes that step again
and its output is held against the program's.  The window's last step
ends a cadence, so it runs every process the configuration has: the
dycore, and the particles' transport and rebalance, with their emission,
coagulation, deposition and chemistry macro-step where they are on.  The
start, which that skips, is held by itself: the reference builds the
initial state from the seed and its fingerprint is held against the
program's.  Each number is 0 when the two agree bit
for bit and is ``inf`` when the program's output is not finite.

- ``start``: the largest relative gap between the two initial states'
  fingerprints (float64 sum, sum of squares and index-weighted sum of
  every tensor).
- ``fields``: the largest gap of any Eulerian leaf (the dycore's u, v, w,
  theta_p, p_p, mu, ph, moist and tracers, the gases, the land and PBL
  states) over the largest magnitude of that leaf in the reference.
- ``slots``: the share of particle slots, alive on either side, in which
  any leaf (number, per-species volume, ids, class, source attribution)
  differs: by more than ``SLOT_RTOL`` of its magnitude, or at all for the
  integer leaves.  A draw at a threshold ``u < p`` can go the other way
  on a last-ulp difference of p, and that particle's slots then differ:
  so a share, not a worst slot.
"""

from __future__ import annotations

import dataclasses

import torch

SLOT_RTOL = 1e-5
TINY = 1e-30


def leaves(obj, prefix: str = "") -> dict:
    """``{path: tensor}`` of a tree of dataclasses, dicts, lists and tuples."""
    out = {}
    if isinstance(obj, torch.Tensor):
        out[prefix] = obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(leaves(getattr(obj, f.name), f"{prefix}.{f.name}" if prefix else f.name))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out.update(leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            out.update(leaves(v, f"{prefix}.{i}" if prefix else str(i)))
    return out


def fingerprint(state) -> dict:
    """``{leaf: float64 [3]}``: each tensor's sum, sum of squares and sum
    weighted by the flat index (kept on the device until read)."""
    out = {}
    for name, t in leaves(state).items():
        x = t.detach().reshape(-1).to(torch.float64)
        w = torch.arange(1, x.numel() + 1, device=x.device, dtype=torch.float64) / max(x.numel(), 1)
        out[name] = torch.stack([x.sum(), (x * x).sum(), (x * w).sum()])
    return out


def start_gap(fp_prog: dict, fp_ref: dict) -> float:
    if fp_prog.keys() != fp_ref.keys():
        return float("inf")
    gap = 0.0
    for k, r in fp_ref.items():
        p = fp_prog[k].to(r.device)
        if not bool(torch.isfinite(p).all()):
            return float("inf")
        gap = max(gap, float(((p - r).abs() / r.abs().clamp(min=TINY)).max()))
    return gap


def _finite(t) -> bool:
    return not t.is_floating_point() or bool(torch.isfinite(t).all())


def field_gap(prog, ref) -> float:
    """``fields``: every leaf of the state but the particles."""
    p_l = {k: v for k, v in leaves(prog).items() if not k.startswith("aero.")}
    r_l = {k: v for k, v in leaves(ref).items() if not k.startswith("aero.")}
    if p_l.keys() != r_l.keys():
        return float("inf")
    gap = 0.0
    for k, r in r_l.items():
        p = p_l[k]
        if p.shape != r.shape or not _finite(p):
            return float("inf")
        d = (p.double() - r.double()).abs().max()
        gap = max(gap, float(d / r.double().abs().max().clamp(min=TINY)))
    return gap


def slot_share(prog_aero, ref_aero) -> float:
    """``slots``: AeroState leaves are [..., P] or [..., X, P]; a slot is
    the last axis."""
    p_l, r_l = leaves(prog_aero), leaves(ref_aero)
    if p_l.keys() != r_l.keys():
        return float("inf")
    alive = (prog_aero.num > 0) | (ref_aero.num > 0)
    cells = alive.shape[:-1]
    off = torch.zeros_like(alive)
    for k, r in r_l.items():
        p = p_l[k]
        if p.shape != r.shape or not _finite(p):
            return float("inf")
        if p.dim() <= len(cells):
            continue                      # a per-cell leaf (the id counter)
        if p.is_floating_point():
            bad = (p - r).abs() > SLOT_RTOL * torch.maximum(p.abs(), r.abs())
        else:
            bad = p != r
        while bad.dim() > alive.dim():
            bad = bad.any(dim=-2)
        off |= bad
    n = int(alive.sum())
    return float((off & alive).sum()) / max(n, 1)


def readings(prog_out, ref_out, fp_prog, fp_ref) -> dict:
    """Every number of the comparison, by name."""
    return {"start": start_gap(fp_prog, fp_ref),
            "fields": field_gap(prog_out, ref_out),
            "slots": slot_share(prog_out.aero, ref_out.aero)}


def nonfinite(tree) -> list:
    """The leaves of ``tree`` that hold a value that is not finite."""
    return [k for k, t in leaves(tree).items() if not _finite(t)]


def to_bfloat16(obj):
    """The control's precision: every float32 tensor of a tree rounded to
    bfloat16 and back (the other leaves as they are)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(torch.bfloat16).to(obj.dtype) if obj.dtype == torch.float32 else obj
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: to_bfloat16(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: to_bfloat16(v) for k, v in obj.items()}
    return obj
