"""Run a worker of a test file in several gloo processes on the CPU.

`spawn(script, worker, world, tmp_path, *args)` starts `world` processes of
`script` (`python SCRIPT WORKER RANK WORLD STORE OUT ARGS...`) in one gloo
group on a `file://` store under `tmp_path`, so no TCP port is taken; each
child imports torch and the port only, runs its worker and saves what it
returns under OUT. `child_main(workers)` is the child's side. Each child
has a CHILD_TIMEOUT_S timeout and one torch thread, so a collective that
hangs fails its test alone.
"""
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120


def spawn(script: str, worker: str, world: int, tmp_path, *args) -> list:
    """Each child's saved result, by rank; every child must exit 0 in time."""
    out = str(tmp_path)
    store = f"file://{tmp_path}/store.{worker}.{time.monotonic_ns()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(script), worker, str(r),
                               str(world), store, out, *map(str, args)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {worker} exited {p.returncode}:\n{log}"
    return [torch.load(os.path.join(out, f"{worker}.{r}.pt")) for r in range(world)]


def child_main(workers: dict) -> None:
    from image_segmentation_tpu_torch.parallel.multihost import initialize_multihost

    torch.set_num_threads(1)
    name, rank, world, store, out, *rest = sys.argv[1:]
    initialize_multihost(store, int(world), int(rank), "cpu")
    result = workers[name](int(rank), int(world), *rest)
    torch.save(result, os.path.join(out, f"{name}.{rank}.pt"))
    torch.distributed.destroy_process_group()
