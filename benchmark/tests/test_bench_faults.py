"""The check of `correct` on the CPU: a sound run of each tiny cell passes;
the control (the reference in bfloat16 in the program's place) and every
fault planted under the timed path (benchmark/harness/faults.py) fail."""

import pytest

from benchmark.harness import faults

SECONDS = {"tiny-batch": 12.0, "tiny-denoised": 3.0, "tiny-instanced": 12.0}


@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_sound_run_is_correct(run_tiny, cell):
    out = run_tiny(cell, seconds=SECONDS[cell])
    assert out["result"]["correct"], out["limits"]


@pytest.mark.parametrize("cell", sorted(SECONDS))
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_caught(run_tiny, cell, fault):
    out = run_tiny(cell, seconds=SECONDS[cell], plant=faults.FAULTS[fault])
    assert not out["result"]["correct"], out["limits"]
    assert out["result"]["failed"] == out["result"]["attempted"]


@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_control_fails(run_tiny, cell):
    from benchmark.control import ReferenceProgram

    out = run_tiny(cell, seconds=SECONDS[cell], make_program=ReferenceProgram)
    assert not out["result"]["correct"], out["limits"]
