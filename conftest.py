"""One thread per library in every test process.

Tier-1 runs several xdist workers on a few cores.  Left alone, each
worker's torch, OpenMP/BLAS and XLA-CPU's Eigen pool would each start one
thread a core, and the workers' threads would fight for the cores.  This
file sits at the root so that pytest loads it before ``tests/conftest.py``
imports jax, and before any test imports torch.  Spawned gloo ranks and
the bench's worker processes inherit the environment.

XLA stops reading ``XLA_FLAGS`` at the first word that does not start
with ``--``, so only flags go in front of what is already there.
"""

import os

os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
_ONE_THREAD = "--xla_cpu_multi_thread_eigen=false"
_flags = os.environ.get("XLA_FLAGS", "")
if _ONE_THREAD not in _flags:
    os.environ["XLA_FLAGS"] = f"{_ONE_THREAD} {_flags}".strip()

import torch  # noqa: E402

torch.set_num_threads(1)    # in case torch was imported before the variables were set
