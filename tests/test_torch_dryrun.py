"""The port's multi-process dry run (parallel/dryrun.py), the counterpart of
`__graft_entry__.dryrun_multichip(n)`: `python -m
image_segmentation_tpu_torch.parallel.dryrun N` over N gloo processes on
the CPU prints JAX's part lines in JAX's order, every one ok with finite
numbers; part 6 pins the sharded eval equal to one process's inside the
run itself."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_parts(n: int) -> list:
    """The part names of JAX's dry run at n devices, in order."""
    tp = 2 if n % 2 == 0 and n >= 2 else 1
    k = min(n, 4)
    return ["dp", "dp-multihost-feed", f"dp{n // tp}xtp{tp}", "dp-epoch-resident", f"sp{k}",
            f"pp{k}", "dp-sharded-eval"]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_prints_jax_parts(n):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "image_segmentation_tpu_torch.parallel.dryrun",
                           str(n)], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith(f"dryrun_multichip({n}) ")]
    parts = [re.match(rf"dryrun_multichip\({n}\) ([\w-]+): ok, (.*)$", l) for l in lines]
    assert all(parts), lines
    assert [p.group(1) for p in parts] == _jax_parts(n)
    for p in parts:
        numbers = [float(v) for v in re.findall(r"-?\d+\.\d+", p.group(2))]
        assert numbers and all(abs(v) < 1e6 for v in numbers), p.group(0)
