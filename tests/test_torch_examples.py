"""The port's examples (``examples/torch/``, twins of the reference's
``examples/``) run to their end on the CPU at their smallest sizes, each
in a subprocess with a time limit."""
import subprocess
import sys

import pytest

from torch_fleet import ROOT, env

CASES = {
    "quickstart.py": ["--device", "cpu", "--small"],
    "xor_dgo.py": ["--device", "cpu", "--small"],
    "serving_batched.py": ["--device", "cpu", "--small"],
    "dgo_subspace_lm.py": ["--device", "cpu", "--small"],
    "lm_train_e2e.py": ["--device", "cpu", "--steps", "40"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_example_runs(name):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch" / name)]
        + CASES[name], capture_output=True, text=True, env=env(2),
        cwd=ROOT, timeout=240)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    assert out.stdout.strip()
