"""What every cell shares: finding a cell's configuration, traffic and
metrics by name, seeded weights and data, the statistics, the checks and
the result line.

A cell of BENCHMARK.json names a configuration and a traffic mix. The
configuration's `file` is its JSON; its `builder` names the module in
`configs/` that builds the served model and the plain reference. The mix
is `traffic/<name>.json`, whose `kind` names the driver in `kinds/`. A
per-layer metric is `metrics/<name>.py`, with `read(reading)`.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "image_segmentation_tpu")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload with everything it names, loaded."""

    name: str
    chips: int
    cfg: dict
    traffic: dict
    builder: object
    kind: object
    end_to_end: List[dict]
    per_layer: List[dict]


def metrics_of(bench: dict, workload: str) -> tuple:
    """(end-to-end, per-layer) metric entries this workload reports: those
    that list it, or that list no cells and, for a per-layer metric, move
    an end-to-end metric the cell reports."""
    def listed(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def load_cell(workload: str, bench_path: Optional[str] = None) -> Cell:
    bench = read_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = read_json(os.path.join(ROOT, conf["file"]))
    traffic = read_json(os.path.join(HERE, "traffic", entry["traffic"] + ".json"))
    builder_name = cfg.get("builder", cfg["name"])
    builder = load_module(os.path.join(HERE, "configs", builder_name + ".py"),
                          f"perfbench_config_{builder_name}")
    kind = load_module(os.path.join(HERE, "kinds", traffic["kind"] + ".py"),
                       f"perfbench_kind_{traffic['kind']}")
    e2e, layer = metrics_of(bench, workload)
    return Cell(workload, entry["chips"], cfg, traffic, builder, kind, e2e, layer)


def metric_reader(name: str) -> Callable:
    mod = load_module(os.path.join(HERE, "metrics", name + ".py"),
                      "perfbench_metric_" + name.replace(".", "_"))
    return mod.read


# -- seeds ------------------------------------------------------------------

# independent streams of one seed
WEIGHTS, DATA, ORDER, SAMPLE = range(4)


def torch_generator(seed: int, stream: int, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 16 + stream) % (2**63))
    return g


def np_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2**63), stream])


def make_weights(builder, cfg: dict, seed: int, device) -> Dict[str, "torch.Tensor"]:
    """The configuration's float32 weights and BatchNorm statistics, keyed by
    the served model's state-dict names, made on `device` from the seed in
    one draw: U(centre - half, centre + half) per leaf by `init_spec`."""
    import torch

    shapes = {k: tuple(v.shape) for k, v in builder.reference(cfg).state_dict().items()}
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=torch_generator(seed, WEIGHTS, device),
                      device=device, dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        centre, half = builder.init_spec(name, shape)
        out[name] = flat[at:at + n].view(shape).mul(half).add_(centre)
        at += n
    return out


def compute_dtype(cfg: dict):
    import torch

    return getattr(torch, cfg["compute_dtype"])


def require_port_norms(layers, cfg: dict) -> None:
    """The port's BatchNorm momentum and epsilon are constants of its
    `models/layers.py`: a configuration that states others is refused."""
    port = (layers.BN_MOMENTUM, layers.BN_EPS)
    if port != (cfg["bn_momentum"], cfg["bn_eps"]):
        raise ValueError(f"the port's BatchNorm (momentum, eps) is {port}; the configuration "
                         f"states {(cfg['bn_momentum'], cfg['bn_eps'])}")


def build(builder, cfg: dict, device, weights: dict, which: str, ops=None):
    """The served model ('port') or the plain reference ('reference') on
    `device`, loaded with `weights`. The port's parameters have to be in
    the configuration's `param_dtype`."""
    import torch

    model = (builder.port(cfg, device) if which == "port"
             else builder.reference(cfg, ops).to_empty(device=device))
    model.load_state_dict(weights, strict=True)
    if which == "port":
        stated = getattr(torch, cfg["param_dtype"])
        other = {p.dtype for p in model.parameters()} - {stated}
        if other:
            raise ValueError(f"the port keeps parameters in {sorted(map(str, other))}; "
                             f"the configuration states {stated}")
        model = model.to(memory_format=torch.channels_last)
    return model.eval()


# -- statistics and checks ----------------------------------------------------

def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


@dataclasses.dataclass
class Check:
    """A number compared with its limit: correct when value <= limit."""

    name: str
    value: float
    limit: Optional[float]

    @property
    def ok(self) -> bool:
        return self.limit is not None and math.isfinite(self.value) and self.value <= self.limit


def checks_from(values: Dict[str, float], limits: Dict[str, Optional[float]]) -> List[Check]:
    return [Check(k, float(v), limits.get(k)) for k, v in values.items()]


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Callable[[str], bool]] = None) -> tuple:
    """(gap, leaf) of the worst leaf by |norm_prog - norm_ref| / max(norm_ref,
    the median leaf's norm)."""
    names = [k for k in ref if keep is None or keep(k)]
    med = float(np.median([ref[k] for k in names]))
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k) for k in names)


# -- the process --------------------------------------------------------------

def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Outcome:
    """What a kind's run hands back to run.py."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    reading: Optional[object] = None  # tracing.Reading with --trace 1
    detail: Optional[dict] = None  # where each compared number was worst


def result_line(cell: Cell, outcome: Outcome, trace: bool, device: dict) -> dict:
    """The last line's object; `checks` comes last."""
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(outcome.reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in outcome.e2e}
    line = {"correct": bool(outcome.checks) and all(c.ok for c in outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if trace and outcome.reading is not None:
        line["breakdown"] = outcome.reading.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line
