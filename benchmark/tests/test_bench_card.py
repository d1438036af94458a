"""One short run of a cell on the card (skips without one): a result line
with the contract's keys, correct, on the card's name."""

import json
import subprocess
import sys

import pytest

from benchmark import spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_short_run_on_the_card(card):
    import torch
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "em_uniform.p1000", "--seed", "4000000001", "--seconds", "3",
                          "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "compared" and line["correct"]
    assert {"step_ms", "peak_gib", "setup_s"} <= set(line["metrics"])
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
