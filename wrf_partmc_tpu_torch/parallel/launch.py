"""Start N ranks of a command on this host.

    python -m wrf_partmc_tpu_torch.parallel.launch -n 4 [--timeout 600] -- \\
        python my_script.py ...

Each process gets ``WPMC_COORDINATOR`` (a free loopback port),
``WPMC_NUM_PROCS`` and ``WPMC_PROC_ID``; the script calls
``parallel.distributed.init_from_env(device)``.  Ranks' output goes to
this process's standard output, prefixed ``[rank r]``.  When one rank
fails or the time limit passes, every rank still running is killed; the
exit code is the code of the rank that failed first in time (124 on the
time limit), never that of a rank the launcher killed.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks(list):
    """``[(exit code, output)]`` by rank, and ``cause``: the rank whose own
    nonzero exit ended the run (None if every rank exited 0 or the time
    limit ended it).  Ranks killed after that exit hold -9."""

    cause: int | None = None

    @property
    def code(self) -> int:
        """The run's exit code: the cause's, else the first nonzero (124 on
        the time limit), else 0."""
        if self.cause is not None:
            return self[self.cause][0]
        return next((c for c, _ in self if c != 0), 0)


def spawn(n: int, argv: list, timeout_s: float = 600.0, env: dict | None = None,
          cwd: str | None = None) -> Ranks:
    """Run ``argv`` as ranks 0..n-1 and wait for all of them.  Returns
    :class:`Ranks`; on the time limit (code 124) or the first failure every
    rank still running is killed, so none is left."""
    base = dict(os.environ if env is None else env)
    base.update(WPMC_COORDINATOR=f"127.0.0.1:{free_port()}", WPMC_NUM_PROCS=str(n))
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(n)]
    procs = [subprocess.Popen(argv, env=dict(base, WPMC_PROC_ID=str(r)), cwd=cwd,
                              stdout=logs[r], stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    deadline = time.monotonic() + timeout_s
    codes = [None] * n
    out = Ranks()
    try:
        while None in codes:
            for r, p in enumerate(procs):
                if codes[r] is None:
                    codes[r] = p.poll()
                    if codes[r] not in (None, 0) and out.cause is None:
                        out.cause = r
            if out.cause is not None or time.monotonic() > deadline:
                timed_out = out.cause is None
                for r, p in enumerate(procs):
                    if codes[r] is None:
                        p.kill()
                        p.wait()
                        codes[r] = 124 if timed_out else -9
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, log in enumerate(logs):
        log.seek(0)
        out.append((codes[r], log.read()))
        log.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", "--nprocs", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd:
        ap.error("no command to launch")
    results = spawn(args.nprocs, cmd, args.timeout)
    for r, (_, text) in enumerate(results):
        for line in text.splitlines():
            print(f"[rank {r}] {line}")
    return results.code


if __name__ == "__main__":
    sys.exit(main())
