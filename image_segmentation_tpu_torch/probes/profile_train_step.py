"""The UNet train step in pieces, and optionally its trace.

Counterpart of the JAX repository's benchmarks/profile_train_step.py. At
256 px, batch 128, a bf16 UNet-64 with Dice + CE (4 × 64², base 8,
float32 on the CPU), it times, each as a median over --steps synchronised
calls with its spread:

  fwd    the train-mode forward without autograd (batch statistics; the
         running statistics move, as flax's mutable batch_stats do)
  grad   the loss and its backward into .grad, no update
  loss   the loss on fixed logits
  opt    one AdamW step on fixed gradients (torch applies the update; the
         JAX probe times the update's computation)
  step   `train.steps.train_step`, the production step

and prints them under the JAX probe's keys with `overhead_vs_3fwd` (step
minus three forwards), `img_per_sec` (batch over the step) and the step's
peak device memory. With --trace DIR it also writes a torch.profiler
trace of 3 steps under DIR (`utils.profiling.trace_context`) and prints
the ops that take the most time a step: the card's kernels, or on the
CPU its ops.

    python -m image_segmentation_tpu_torch.probes.profile_train_step
        [--batch 128] [--size 256] [--steps 10] [--trace DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import torch

from image_segmentation_tpu_torch.probes import cli_device, production_step, stamp, sync, timed

TRACE_STEPS = 3


def top_ops(trace_dir: str, steps: int, top: int = 40) -> list:
    """(ms a step, name) of the `top` costliest kernels of the newest trace
    under `trace_dir`, or of its CPU ops when it holds no kernel."""
    files = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json*"), recursive=True)
    if not files:
        raise FileNotFoundError(f"no torch.profiler trace under {trace_dir}")
    with open(max(files, key=os.path.getmtime)) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    cat = "kernel" if any(e.get("cat") == "kernel" for e in events) else "cpu_op"
    durs = {}
    for e in events:
        if e.get("cat") == cat:
            durs[e["name"]] = durs.get(e["name"], 0.0) + e["dur"]
    return [(d / 1e3 / steps, name) for name, d in sorted(durs.items(), key=lambda kv: -kv[1])
            [:top]]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m image_segmentation_tpu_torch.probes.profile_train_step")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--trace", default="")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    from image_segmentation_tpu_torch.train.steps import train_step
    from image_segmentation_tpu_torch.utils.profiling import trace_context

    device = cli_device(args.device)
    state, x, y, loss_fn = production_step(device, args.batch, args.size)
    model, opt = state.model, state.optimizer
    model.train()

    def fwd():
        with torch.no_grad():
            return model(x)

    def grad():
        model.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), y)
        loss.backward()
        return loss

    results = {"fwd": timed(fwd, args.steps, device), "grad": timed(grad, args.steps, device)}
    logits = fwd()
    results["loss"] = timed(lambda: loss_fn(logits, y), args.steps, device)
    grad()  # fixed gradients in .grad for the optimizer
    results["opt"] = timed(opt.step, args.steps, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    results["step"] = timed(lambda: train_step(state, loss_fn, x, y), args.steps, device)

    out = {k: t.ms for k, t in results.items()}
    out["overhead_vs_3fwd"] = results["step"].ms - 3 * results["fwd"].ms
    out["img_per_sec"] = x.shape[0] / (results["step"].ms / 1e3)
    out["spread_ms"] = {k: [t.min_ms, t.max_ms] for k, t in results.items()}
    out["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else None)
    out = stamp({**out, "batch": x.shape[0], "size": x.shape[1], "steps": args.steps}, device)
    print(json.dumps(out), flush=True)

    if args.trace:
        with trace_context(args.trace):
            for _ in range(TRACE_STEPS):
                train_step(state, loss_fn, x, y)
            sync(device)
        out["top_ops"] = top_ops(args.trace, TRACE_STEPS)
        for ms, name in out["top_ops"]:
            print(f"{ms:10.3f} ms/step  {name[:110]}")
    return out


if __name__ == "__main__":
    main()
