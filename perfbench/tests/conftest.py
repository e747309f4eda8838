"""The benchmark's CPU tests: the repository's root on the path, and cells
cut to a size the CPU runs in seconds (`tiny_cell`)."""
import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIGS = {
    "unet64": {"base": 8, "image_size": 32},
    "clipunet_vitb16": {"image_size": 32, "patch_size": 8, "hidden_size": 64,
                        "num_hidden_layers": 4, "num_attention_heads": 2,
                        "intermediate_size": 128, "decoder_channels": [64, 32, 16, 8],
                        "skip_indices": [1, 2, 3]},
}
TINY_TRAFFIC = {
    "train_closed": {"set_size": 12, "micro_batch": 2, "accum_steps": 2, "warmup_steps": 1,
                     "trace_steps": 2},
    "serve_open": {"rate_per_s": 20.0, "sizes": {"mix": "oxford_iiit_pet", "scale": 0.12}, "check_requests": 4,
                   "warmup_requests": 3, "clients": 4},
}


def tiny(cell):
    """The cell at CPU size: small widths and images, a small train set,
    small photos at a low rate. Limits stay as the cell states them."""
    cell = copy.copy(cell)
    cell.cfg = dict(cell.cfg, **TINY_CONFIGS[cell.cfg["name"]])
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC[cell.traffic["kind"]])
    return cell


@pytest.fixture(scope="session")
def bench_path(tmp_path_factory):
    """BENCHMARK.json with the cells of `extra_cells.json` added: cells
    built, run correct on the card and left out of the benchmark for their
    spread (PERF.md, Open questions), whose drivers, configuration and
    metrics stay tested here."""
    from perfbench import harness

    bench = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    extra = harness.read_json(os.path.join(os.path.dirname(__file__), "extra_cells.json"))
    for key, entries in extra.items():
        have = {m["name"]: m for m in bench[key]}
        for m in entries:  # an entry of the benchmark's own name only lists more cells
            if m["name"] in have:
                have[m["name"]]["workloads"] = have[m["name"]]["workloads"] + m["workloads"]
            else:
                bench[key].append(m)
    path = tmp_path_factory.mktemp("bench") / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return str(path)


@pytest.fixture
def tiny_cell(bench_path):
    from perfbench import harness

    return lambda name: tiny(harness.load_cell(name, bench_path))
