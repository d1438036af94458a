"""How each configuration is built from a seed: one file each,
``<config>.py`` with ``build(config, traffic, seed, device, root=PROGRAM)``.

The port's own builders fix the random streams' seed at 0, so these
assemble the model from the port's public pieces with the seed's key, the
same pieces in the same order as ``entry.build``.  ``root`` names the
package whose pieces are assembled: the program, or the configuration's
plain reference, a frozen copy of it under ``benchmark/reference/`` (the
configuration file's ``"reference"``), so both sides build the same start,
each with its own code, from one assembly.
"""

import importlib

PROGRAM = "wrf_partmc_tpu_torch"
REFERENCES = "benchmark.reference"
MASK32 = 0xFFFFFFFF


def module(root: str, name: str):
    """``<root>.<name>``: a module of the program or of a plain reference
    (``benchmark.reference.<package>``); any other root is refused."""
    head, _, package = root.rpartition(".")
    if root != PROGRAM and not (head == REFERENCES and package.isidentifier()):
        raise ValueError(f"root {root!r} is neither {PROGRAM!r} nor {REFERENCES}.<package>")
    return importlib.import_module(f"{root}.{name}")


def seed_words(seed: int) -> tuple:
    """The threefry key words of a seed of up to 64 bits (high, low), as
    ``jax.random.key`` splits a 64-bit seed."""
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed {seed} is outside [0, 2^64)")
    return ((seed >> 32) & MASK32, seed & MASK32)


def check_config(cfg, config: dict) -> None:
    """Raise unless the built ``Config`` runs the sizes and the processes
    that the configuration's file states."""
    d, dy, pc = cfg.domain, cfg.dynamics, cfg.partmc
    built = {"nx": d.nx, "ny": d.ny, "nz": d.nz, "dx": d.dx, "dy": d.dy, "ztop": d.ztop,
             "dt": dy.dt, "partmc_chem_dt": pc.partmc_chem_dt,
             "processes": {k: getattr(pc, k) for k in config["processes"]}}
    want = {k: config[k] for k in built}
    if built != want:
        raise ValueError(f"the build runs {built}, the configuration states {want}")
