"""On the card: one short run of each cell from the command line, correct
and with a well-formed last line. Skips without an NVIDIA GPU."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["merged-batch-b3", "merged-denoised-still", "instanced-batch-b4"])
def test_cell_runs_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA kernels")
    out = subprocess.run([sys.executable, os.path.join("benchmark", "run.py"), "--workload", cell,
                          "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=tiny.REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["limits"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
