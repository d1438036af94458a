"""Source / weight-class universe discovery (port of
``wrf_partmc_tpu/models/partmc/sources.py``): every named input becomes one
source with its own weight class, and sea salt appends its two classes."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

SEASALT_CLASSES = ("seasalt_film", "seasalt_spume")   # the two sea-salt classes


@dataclass(frozen=True)
class SourceUniverse:
    """Registry of discovered sources and their weight classes."""

    sources: tuple
    classes: tuple
    source_class: tuple

    @property
    def n_source(self) -> int:
        return len(self.sources)

    @property
    def n_class(self) -> int:
        return len(self.classes)

    def source_id(self, name: str) -> int:
        return self.sources.index(name)


def build_universe(ic=(), bc=(), emissions=(), seasalt: bool = False):
    """Register the sources of (name, AeroDist) inputs and rewrite each
    dist's per-mode ``source``/``w_class`` ids.  With ``seasalt`` one
    'seasalt' source is added with two weight classes, film ('seasalt') and
    spume ('seasalt_spume'), split by size when sampled.  Returns
    (universe, ic_dists, bc_dists, emit_dists)."""
    sources: list = []
    classes: list = []
    source_class: list = []

    def register(name):
        if name in sources:
            return sources.index(name)
        sources.append(name)
        classes.append(name)
        source_class.append(classes.index(name))
        return len(sources) - 1

    def assign(named):
        out = []
        for name, dist in named:
            sid = register(name)
            cid = source_class[sid]
            m = dist.num_conc.shape[-1]
            dev = dist.num_conc.device
            out.append(dataclasses.replace(
                dist, source=torch.full((m,), sid, dtype=torch.int32, device=dev),
                w_class=torch.full((m,), cid, dtype=torch.int32, device=dev)))
        return tuple(out)

    ic_d = assign(ic)
    bc_d = assign(bc)
    em_d = assign(emissions)
    if seasalt:
        sid = register("seasalt")
        classes.append("seasalt_spume")
        source_class[sid] = classes.index("seasalt")
    uni = SourceUniverse(sources=tuple(sources), classes=tuple(classes),
                         source_class=tuple(source_class))
    return uni, ic_d, bc_d, em_d


def validate_universe(uni: SourceUniverse, n_class_cfg: int) -> None:
    if uni.n_class > n_class_cfg:
        raise ValueError(
            f"universe has {uni.n_class} weight classes ({uni.classes}) but "
            f"Config.n_class={n_class_cfg}; raise n_class")
