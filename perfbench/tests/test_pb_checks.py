"""The check decides `correct` by the limits the configurations state: a
sound run at a CPU size passes, and a run with its timed path broken
underneath, or the float8 control in the program's place, does not. Each
drives the rest of a run past the look for a card."""
import time

import pytest

from perfbench import harness

SEED = 2**31 + 123
TRAIN = ["unet64_train_b64", "clipunet_train_b64"]
SERVE = ["unet64_serve_poisson", "clipunet_serve_poisson"]


def _line(cell, fault=None):
    outcome = cell.kind.run(cell, SEED, 1.0, False, "cpu", time.perf_counter(), fault=fault)
    dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return harness.result_line(cell, outcome, False, dev)


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_a_sound_run_is_correct(tiny_cell, workload):
    line = _line(tiny_cell(workload))
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("workload, fault", [(w, f) for w in TRAIN
                                             for f in ("unchanged", "half_batch")]
                         + [(w, "altered_answer") for w in SERVE])
def test_a_broken_timed_path_is_not_correct(tiny_cell, workload, fault):
    line = _line(tiny_cell(workload), fault)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_the_float8_control_fails_a_limit(tiny_cell, workload):
    cell = tiny_cell(workload)
    values = (cell.kind.control(cell, SEED, "cpu") if workload in TRAIN
              else cell.kind.control(cell, SEED, "cpu", 1.0))
    values.pop("detail", None)
    checks = harness.checks_from(values, cell.cfg["limits"][
        "train" if workload in TRAIN else "serve"])
    assert not all(c.ok for c in checks), values
