"""Where the train step's device time goes, by direction and module, and
per convolution.

Counterpart of the JAX repository's benchmarks/backward_anatomy.py, which
joins the compiled HLO's op_name metadata to a profiler trace. There is no
HLO here: this probe attributes the device time of a torch.profiler trace
of the production step (`train.steps.train_step`; B 128, 256 px, bf16
UNet-64, Dice + CE; 4 × 64², base 8, float32 on the CPU) to the ops that
launched it. On the card a unit of time is a kernel (or a copy), charged
to the innermost op that holds the runtime call launching it
(`_Launches`); on the CPU, where there are no kernels, each op's own CPU
time stands in.

Attribution, for each unit, from the op that launched it up its parents:
  * direction: backward if the op ran under an
    `autograd::engine::evaluate_function: <Node>` event. Backward kernels
    inherit no forward scope, so the node's `sequence_nr`, which is the
    forward op's that made the node, gives its forward op, and that op's
    scope its layer;
  * layer: the innermost `module::<path>` scope, pushed by forward hooks
    on every module while the trace runs (the port's module paths: e.g.
    `down2.conv.conv1`, `up1.up`; the UNet's own ops, the 1×1 head among
    them, are `output`'s and the root's);
  * kind: conv (under `aten::convolution`, or a ConvolutionBackward node),
    bn (a BatchNorm module's scope, or a NativeBatchNorm node), pool
    (max pool and its node), else other (ReLU, casts, the concat);
  * buckets: fwd/{conv,bn,pool,other}, bwd/{conv,bn,pool,other}, loss
    (forward and backward of the ops in a `loss` scope around the loss
    call), optimizer/update (under `Optimizer.step` or `zero_grad`) and
    step/other (the rest of `train_step`). JAX's op_name test puts a
    ConvBNRelu's ReLU under conv; here it is other.

Prints one JSON line (`train_step_per_op_anatomy_ms`): ms a step by
bucket and share of the device time, the trace's device time a step, the
measured fwd:bwd ratio, what no op claimed, the step's wall ms and
images/s. Under --per-conv a second line has one row per conv, layer and
kind: fwd, dgrad, wgrad and bias (the bias gradient's reduction), with ms
a step, analytic GFLOP a step (2·N·H·W·Cin·Cout·k² per direction, H × W
the output's for a conv and the input's for the 2×2 transpose conv; N·H·W
·Cout additions for the bias) and TFLOP/s. A ConvolutionBackward node's
measured time is split by kind in proportion to calibration calls of
`aten::convolution_backward` at the layer's shapes, one output mask at a
time (dgrad, wgrad and the bias reduction are separate kernels whose
names differ between cuDNN versions, so the node's kernels are not
sorted by name).

    python -m image_segmentation_tpu_torch.probes.backward_anatomy [--per-conv]
        [--batch 128] [--size 256] [--trace-steps 3] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from image_segmentation_tpu_torch.probes import cli_device, production_step, stamp, sync, timed

BUCKETS = ("fwd/conv", "fwd/bn", "fwd/pool", "fwd/other", "bwd/conv", "bwd/bn", "bwd/pool",
           "bwd/other", "loss", "optimizer/update", "step/other")
SCOPE = "module::"
BACKWARD = "autograd::engine::evaluate_function: "
LOSS_SCOPE = "loss"
CONV_OP = "aten::convolution"
KINDS = ("dgrad", "wgrad", "bias")  # convolution_backward's output mask order


@contextlib.contextmanager
def module_scopes(model: torch.nn.Module):
    """A `module::<path>` record_function scope around every module's
    forward while inside (the root UNet's path is "")."""
    stack, handles = [], []

    def pre(name):
        def hook(module, args):
            scope = record_function(SCOPE + name)
            scope.__enter__()
            stack.append(scope)
        return hook

    def post(module, args, out):
        stack.pop().__exit__(None, None, None)

    for name, m in model.named_modules():
        handles += [m.register_forward_pre_hook(pre(name)), m.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _chain(e):
    while e is not None:
        yield e
        e = e.cpu_parent


def _is_cpu(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CPU


def conv_geometry(model, layer: str, in_shape, w_shape) -> dict:
    """A conv of the UNet at `layer` (a ConvBNRelu, an UpConv, or the root,
    whose conv is the 1×1 head) on an input of `in_shape` (NCHW) with a
    weight of `w_shape`: its GFLOP a direction and its bias's additions,
    and the arguments `aten::convolution_backward` takes for it."""
    from image_segmentation_tpu_torch.models.layers import UpConv

    n, cin, h, w = in_shape
    module = model.get_submodule(layer)
    transposed = isinstance(module, UpConv)
    k = w_shape[2] * w_shape[3]
    cout = w_shape[1] if transposed else w_shape[0]
    stride, padding = (2, 0) if transposed else (1, (w_shape[2] - 1) // 2)
    out_hw = (2 * h, 2 * w) if transposed else (h, w)
    return {"gflops": 2.0 * n * h * w * cin * cout * k / 1e9,
            "bias_gflops": n * out_hw[0] * out_hw[1] * cout / 1e9,
            "args": (tuple(in_shape), tuple(w_shape), (n, cout, *out_hw), cout, stride, padding,
                     transposed)}


class _Calibration:
    """The ms of `aten::convolution_backward` at a conv's shapes, one output
    mask at a time, in the model's dtype and layout (`timed`: medians over
    synchronised calls; no profiler session, whose short sessions lose
    device records)."""

    def __init__(self, device, dtype, calls: int = 5):
        self.device, self.dtype, self.calls, self.cache = torch.device(device), dtype, calls, {}

    def __call__(self, args, kinds) -> Dict[str, float]:
        key = (args, kinds)
        if key not in self.cache:
            in_shape, w_shape, out_shape, cout, stride, padding, transposed = args
            make = lambda s: torch.randn(s, device=self.device, dtype=self.dtype).to(  # noqa: E731
                memory_format=torch.channels_last)
            go, x, w = make(out_shape), make(in_shape), make(w_shape)
            out = {}
            for kind in kinds:
                mask = [k == kind for k in KINDS]
                out[kind] = timed(lambda: torch.ops.aten.convolution_backward(
                    go, x, w, [cout], [stride] * 2, [padding] * 2, [1, 1], transposed, [0, 0], 1,
                    mask), self.calls, self.device).ms
            self.cache[key] = out
        return self.cache[key]


def _annotation(e) -> bool:
    """A record_function range (this probe's scopes, the optimizer's), which
    the profiler also projects onto the card's timeline over the kernels it
    encloses: not device work of its own."""
    return (getattr(e, "is_user_annotation", False) or e.name.startswith(SCOPE)
            or e.name == LOSS_SCOPE or e.name.startswith("Optimizer."))


def _device_events(events) -> list:
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and not _annotation(e)]


def whole_trace(fn, device, record_shapes: bool = False, sessions: int = 8):
    """A torch.profiler trace of fn() whose device records are whole. A
    session now and then loses device records (none at all, or some of a
    kernel's launches; chip_smoke.py `_device_profile`); every session runs
    the same work, so sessions run until two agree on every kernel's count,
    and the later of them is kept. Off a card one session is whole."""
    import collections

    device = torch.device(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    seen = []
    for _ in range(sessions):
        with profile(activities=acts, record_shapes=record_shapes) as prof:
            fn()
            sync(device)
        if device.type != "cuda":
            return prof
        counts = collections.Counter(e.name for e in _device_events(prof.events()))
        if counts and counts in seen:
            return prof
        seen.append(counts)
    raise RuntimeError(f"torch.profiler lost device records: no two of {sessions} sessions "
                       f"agreed on every kernel's count (kernels seen: "
                       f"{[sum(c.values()) for c in seen]})")


def _runtime(e) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...), not an op."""
    return e.name.startswith("cu") and not e.name.startswith("cudnn")


class _Launches:
    """The op that launched a kernel: the innermost op, on any thread, whose
    time range holds the start of the runtime call that launched it. The
    kernel and that call share their CUPTI correlation id (the events' `id`).
    The profiler's own kernel lists (`e.kernels`) are not used: they link
    by the op's correlation id, which the forward's thread and the autograd
    engine's can share, and then hang a kernel on both ops."""

    def __init__(self, events):
        import bisect
        import collections

        self.bisect = bisect.bisect_right
        self.runtime = {e.id: e for e in events if _is_cpu(e) and _runtime(e)}
        by_thread = collections.defaultdict(list)
        for e in events:
            if _is_cpu(e) and not _runtime(e) and not e.is_async:
                by_thread[e.thread].append(e)
        self.threads = []
        for ops in by_thread.values():
            ops.sort(key=lambda e: e.time_range.start)
            self.threads.append(([e.time_range.start for e in ops], ops))

    def op(self, kernel):
        call = self.runtime.get(kernel.id)
        if call is None:
            return None
        t = call.time_range.start
        best = None
        for starts, ops in self.threads:
            i = self.bisect(starts, t) - 1
            e = ops[i] if i >= 0 else None
            while e is not None and e.time_range.end < t:
                e = e.cpu_parent
            if e is not None and (best is None or e.time_range.start > best.time_range.start):
                best = e
        return best


def device_units(prof, device) -> List[tuple]:
    """(launching op, name, µs) of every unit of device time in a trace: on
    a card each kernel or copy charged to the op that launched it (None
    when no op holds its launch), on the CPU each op's own time."""
    events = prof.events()
    if torch.device(device).type != "cuda":
        return [(e, e.name, e.self_cpu_time_total) for e in events if _is_cpu(e)]
    launches = _Launches(events)
    units = [(launches.op(d), d.name, d.time_range.elapsed_us())
             for d in _device_events(events)]
    if sum(op is not None for op, _, _ in units) * 2 < len(units):
        raise RuntimeError(
            f"backward_anatomy: {sum(op is None for op, _, _ in units)} of {len(units)} "
            f"device events have no runtime call of their correlation id in this "
            f"profiler's trace (torch {torch.__version__})")
    return units


def trace_total_us(prof, device) -> float:
    """The trace's device time: every kernel, copy and memset on the card;
    every op's own time on the CPU."""
    events = prof.events()
    if torch.device(device).type == "cuda":
        return sum(e.time_range.elapsed_us() for e in _device_events(events))
    return sum(e.self_cpu_time_total for e in events if _is_cpu(e))


class Attribution:
    """Each unit's bucket, layer and conv anchor (module docstring)."""

    def __init__(self, model, events):
        self.model = model
        self.forward = {}  # sequence_nr → (layer, in loss, conv event or None)
        for e in events:
            if not _is_cpu(e) or e.sequence_nr < 0 or self._backward_node(e) is not None:
                continue
            layer, in_loss, conv = self._forward_scope(e)
            if e.name == CONV_OP or e.sequence_nr not in self.forward:
                self.forward[e.sequence_nr] = (layer, in_loss, conv)

    @staticmethod
    def _backward_node(e):
        return next((a for a in _chain(e) if a.name.startswith(BACKWARD)), None)

    @staticmethod
    def _forward_scope(e):
        layer, in_loss, conv = None, False, None
        for a in _chain(e):
            if layer is None and a.name.startswith(SCOPE):
                layer = a.name[len(SCOPE):]
            in_loss |= a.name == LOSS_SCOPE
            if conv is None and a.name == CONV_OP:
                conv = a
        return layer, in_loss, conv

    def _module_kind(self, layer: str, chain) -> str:
        from image_segmentation_tpu_torch.models.layers import BatchNorm

        names = [a.name for a in chain]
        if CONV_OP in names:
            return "conv"
        if isinstance(self.model.get_submodule(layer), BatchNorm):
            return "bn"
        if any(n.startswith("aten::max_pool2d") for n in names):
            return "pool"
        return "other"

    def __call__(self, e) -> tuple:
        """(bucket, layer or None, the conv op or backward node it belongs
        to, or None) of a unit launched by op `e`."""
        chain = list(_chain(e))
        node = next((a for a in chain if a.name.startswith(BACKWARD)), None)
        if node is not None:
            layer, in_loss, _ = self.forward.get(node.sequence_nr, (None, False, None))
            if in_loss:
                return "loss", None, None
            kind = node.name[len(BACKWARD):]
            if "Convolution" in kind:
                return "bwd/conv", layer, node
            bucket = ("bwd/bn" if "BatchNorm" in kind else
                      "bwd/pool" if "MaxPool" in kind else "bwd/other")
            return bucket, layer, None
        if any(a.name.startswith("Optimizer.") for a in chain):
            return "optimizer/update", None, None
        if any(a.name == LOSS_SCOPE for a in chain):
            return "loss", None, None
        layer, _, conv = self._forward_scope(e)
        if layer is None:
            return "step/other", None, None
        return f"fwd/{self._module_kind(layer, chain)}", layer, conv


def anatomy(model, prof, device, steps: int, per_conv: bool = False,
            dtype: Optional[torch.dtype] = None) -> dict:
    """The bucket table of a trace of `steps` steps, and under `per_conv`
    the per-conv rows (module docstring)."""
    units = device_units(prof, device)
    attr = Attribution(model, prof.events())
    buckets = dict.fromkeys(BUCKETS, 0.0)
    convs = {}  # anchor event id → (anchor, layer, direction, [(name, µs)])
    for e, name, us in units:
        if e is None:
            continue
        bucket, layer, anchor = attr(e)
        buckets[bucket] += us
        if anchor is not None:
            convs.setdefault(id(anchor), (anchor, layer, bucket[:3], []))[3].append((name, us))
    total = trace_total_us(prof, device)
    table = {k: v / 1e3 / steps for k, v in buckets.items()}
    fwd = sum(v for k, v in table.items() if k.startswith("fwd/"))
    bwd = sum(v for k, v in table.items() if k.startswith("bwd/"))
    out = {"buckets_ms_per_step": table,
           "shares": {k: v / total for k, v in buckets.items()},
           "device_total_ms": total / 1e3 / steps,
           "attributed_share": sum(buckets.values()) / total,
           "unmatched_ms": (total - sum(buckets.values())) / 1e3 / steps,
           "fwd_ms": fwd, "bwd_ms": bwd, "bwd_over_fwd": bwd / fwd if fwd else None}
    if per_conv:
        out["per_conv"] = per_conv_rows(model, attr, convs, device, steps, dtype)
    return out


def per_conv_rows(model, attr, convs, device, steps: int, dtype) -> list:
    from image_segmentation_tpu_torch.models.layers import ConvBNRelu

    calibrate = _Calibration(device, dtype)
    rows = {}

    def add(layer, kind, gflops, us):
        r = rows.setdefault((layer, kind), {"layer": layer, "kind": kind, "gflops": 0.0,
                                            "ms": 0.0})
        r["gflops"] += gflops / steps
        r["ms"] += us / 1e3 / steps

    # the stem's first conv, whose input (the image) needs no gradient
    first_conv = next(name for name, m in model.named_modules() if isinstance(m, ConvBNRelu))
    for anchor, layer, direction, units in convs.values():
        layer = layer or "output"  # the root's conv is the 1×1 head
        if direction == "fwd":
            geo = conv_geometry(model, layer, anchor.input_shapes[0], anchor.input_shapes[1])
            add(layer, "fwd", geo["gflops"], sum(us for _, us in units))
            continue
        fwd_conv = attr.forward.get(anchor.sequence_nr, (None, None, None))[2]
        geo = conv_geometry(model, layer, fwd_conv.input_shapes[0], fwd_conv.input_shapes[1])
        kinds = tuple(k for k in KINDS if not (k == "dgrad" and layer == first_conv))
        cal = calibrate(geo["args"], kinds)
        total = sum(us for _, us in units)
        for k in kinds:
            flops = geo["bias_gflops"] if k == "bias" else geo["gflops"]
            add(layer, k, flops, total * cal[k] / sum(cal.values()))
    out = []
    for r in rows.values():
        r["tflops_per_sec"] = r["gflops"] / r["ms"] if r["ms"] > 0 else None
        out.append(r)
    return sorted(out, key=lambda r: -r["ms"])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m image_segmentation_tpu_torch.probes.backward_anatomy")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--trace-steps", type=int, default=3)
    p.add_argument("--steps", type=int, default=10, help="timed steps before the trace")
    p.add_argument("--per-conv", action="store_true",
                   help="emit the per-convolution speed-of-light table")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    from image_segmentation_tpu_torch.train.steps import train_step

    device = cli_device(args.device)
    state, x, y, loss_fn = production_step(device, args.batch, args.size)

    def scoped_loss(logits, targets):
        with record_function(LOSS_SCOPE):
            return loss_fn(logits, targets)

    run_step = lambda: train_step(state, scoped_loss, x, y)  # noqa: E731
    step = timed(run_step, args.steps, device)
    with module_scopes(state.model):
        prof = whole_trace(lambda: [run_step() for _ in range(args.trace_steps)], device,
                           record_shapes=True)
    res = anatomy(state.model, prof, device, args.trace_steps, args.per_conv, state.model.dtype)
    per_conv = res.pop("per_conv", None)
    out = stamp({"metric": "train_step_per_op_anatomy_ms", **res, "wall_step_ms": step.ms,
                 "wall_step_spread_ms": [step.min_ms, step.max_ms],
                 "img_per_sec": x.shape[0] / (step.ms / 1e3), "batch": x.shape[0],
                 "size": x.shape[1]}, device)
    print(json.dumps(out), flush=True)
    total = res["device_total_ms"]
    print("\n  bucket              ms/step   share", file=sys.stderr)
    for k, v in sorted(res["buckets_ms_per_step"].items(), key=lambda kv: -kv[1]):
        print(f"  {k:<18} {v:>8.3f}   {v / total:>6.1%}", file=sys.stderr)
    if per_conv is not None:
        conv_ms = sum(r["ms"] for r in per_conv if r["kind"] != "bias")
        line = stamp({"metric": "train_step_per_conv_speed_of_light", "batch": x.shape[0],
                      "size": x.shape[1], "rows": per_conv, "conv_ms": conv_ms,
                      "outside_conv_share": 1.0 - conv_ms / total}, device)
        print(json.dumps(line), flush=True)
        print("\n  layer                  kind     ms/step    GFLOP  TFLOP/s", file=sys.stderr)
        for r in per_conv:
            tf = f"{r['tflops_per_sec']:8.1f}" if r["tflops_per_sec"] else "       -"
            print(f"  {r['layer']:<22} {r['kind']:<6} {r['ms']:>9.3f} {r['gflops']:>8.2f} {tf}",
                  file=sys.stderr)
        out["per_conv"] = line
    return out


if __name__ == "__main__":
    main()
