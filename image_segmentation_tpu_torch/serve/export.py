"""Ahead-of-time export of the serving forward, with `torch.export` in
place of the JAX package's `jax.export` (image_segmentation_tpu/serve/
export.py).

The exported program is the engine's whole device half for one family:
staged arrays in ((B, T, T, 3), plus (B, T, T, 1) for a prompt model;
uint8 under fast transfer, else float32), /255 on the device, the model
in eval mode, and the scores out (bfloat16 under fast transfer, else
float32). The weights are in the program and the batch dimension is
symbolic, so one program serves single requests and BatchingEngine
buckets alike. The trace runs under `torch.no_grad()`: `UNet.forward`
takes K1 only without autograd (models/unet.py), and while the trace runs
the kernel wrappers emit K1, K3 and K4 as the `istpu::` torch ops
(ops/kernels), so the program launches the same hand-written kernels
when it is served on a card, and their plain versions on the CPU.

A program serves the device type it was exported on and no other (its
constants and device checks are traced there): `load_exported` refuses
any other, and JAX's `--platforms` has no counterpart. Loading imports
the port's op registrations and no model class or checkpoint code.

Artifact format (`{name}.istpt`, a zip; `.istpu` is the JAX package's):
  meta.json    name, target_size, class_names, needs_prompt, the input,
               output and compute dtypes, the number of inputs, the
               device type it was exported on, the torch version, and the
               format version;
  program.pt2  the `torch.export.save` bytes of the ExportedProgram.

Producer: `export_model` / `save_exported` / `export_registry` / the CLI
(python -m image_segmentation_tpu_torch.serve.export --models-dir DIR
--out EXPORTS [--model unet] [--demo] [--float32] [--device cpu]).
Consumer: `load_exported`, `InferenceEngine.register_exported`, and
serve/app.py's `--exports-dir`.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import time
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

# the ops a program calls must be registered before it loads
from image_segmentation_tpu_torch.ops.kernels import attention, double_conv, mlp  # noqa: F401

ARTIFACT_VERSION = 1
ARTIFACT_EXT = ".istpt"
PROGRAM_FILE = "program.pt2"


class ServingForward(nn.Module):
    """The engine's device half (`_to_device`, the model, `_on_device`'s
    cast) as one module."""

    def __init__(self, model: nn.Module, fast_transfer: bool):
        super().__init__()
        self.model = model
        self.fast_transfer = fast_transfer

    def forward(self, x: torch.Tensor, heatmap: Optional[torch.Tensor] = None) -> torch.Tensor:
        staged = (x,) if heatmap is None else (x, heatmap)
        inputs = [t.float() / 255.0 if t.dtype == torch.uint8 else t.float() for t in staged]
        scores = self.model(*inputs)
        return scores.to(torch.bfloat16) if self.fast_transfer else scores.float()


def export_model(model: nn.Module, target_size: int, *, needs_prompt: bool = False,
                 fast_transfer: bool = True):
    """Trace the serving forward of `model` (on its own device) → (the
    ExportedProgram, meta)."""
    device = next(model.parameters()).device
    in_dtype = torch.uint8 if fast_transfer else torch.float32
    names = ("x", "heatmap") if needs_prompt else ("x",)
    # batch 2: an example of 1 would fix the batch size
    example = tuple(torch.zeros((2, target_size, target_size, c), dtype=in_dtype,
                                device=device) for c in (3, 1)[:len(names)])
    batch = torch.export.Dim("batch", min=1)
    model.eval()
    with torch.no_grad():
        program = torch.export.export(ServingForward(model, fast_transfer), example,
                                      dynamic_shapes={n: {0: batch} for n in names})
    meta = {
        "version": ARTIFACT_VERSION,
        "target_size": int(target_size),
        "needs_prompt": bool(needs_prompt),
        "num_inputs": len(names),
        "input_dtype": "uint8" if fast_transfer else "float32",
        "output_dtype": "bfloat16" if fast_transfer else "float32",
        "compute_dtype": str(getattr(model, "dtype", torch.float32)).replace("torch.", ""),
        "device_type": device.type,
        "torch_version": torch.__version__,
    }
    return program, meta


def save_exported(path: str, model: nn.Module, target_size: int, *, name: str,
                  class_names: Sequence[str], needs_prompt: bool = False,
                  fast_transfer: bool = True) -> dict:
    """Export and write a `{name}.istpt` artifact. Returns its meta."""
    program, meta = export_model(model, target_size, needs_prompt=needs_prompt,
                                 fast_transfer=fast_transfer)
    meta.update(name=name, class_names=list(class_names))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        z.writestr(PROGRAM_FILE, buf.getvalue())
    return meta


def _quantize_uint8(x: torch.Tensor) -> torch.Tensor:
    """engine.quantize_uint8 on the device (round half to even, as numpy)."""
    return torch.clamp(torch.round(x.float() * 255.0), 0, 255).to(torch.uint8)


def load_exported(path: str, device="cuda"):
    """Read an artifact → (call, meta). `call(*staged)` takes the staged
    arrays (numpy, or tensors) as uint8 or float in [0, 1], adapts them on
    the device to the dtype the program was exported with, and returns the
    program's device scores. Raises on another format version, and on a
    device whose type is not the one the program was exported on."""
    device = torch.device(device)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        blob = z.read(PROGRAM_FILE)
    if meta.get("version") != ARTIFACT_VERSION:
        raise ValueError(f"{path}: artifact version {meta.get('version')} != "
                         f"{ARTIFACT_VERSION} (re-export with this build)")
    if meta["device_type"] != device.type:
        raise ValueError(
            f"{path}: exported on {meta['device_type']}, refused on {device.type}; a program "
            f"serves the device type it was traced on (re-export with --device {device.type})")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path}: exported for cuda, and no CUDA device is available")
    program = torch.export.load(io.BytesIO(blob)).module()
    wants_uint8 = meta["input_dtype"] == "uint8"

    def adapt(x) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        t = t.to(device, non_blocking=True)
        if wants_uint8:
            return t if t.dtype == torch.uint8 else _quantize_uint8(t)
        return t.float() / 255.0 if t.dtype == torch.uint8 else t.float()

    def call(*inputs) -> torch.Tensor:
        with torch.inference_mode():
            return program(*(adapt(x) for x in inputs))

    return call, meta


def export_registry(models_dir: str, out_dir: str, *, only: Optional[str] = None,
                    fast_transfer: bool = True, demo: bool = False, device="cuda") -> list:
    """Export every (or one) family of the trained checkpoints in
    `models_dir` (serve/app.py `load_family_models`), or of the demo
    registry, to `{out_dir}/{name}.istpt`, traced on `device`."""
    from image_segmentation_tpu_torch.serve import app
    from image_segmentation_tpu_torch.serve.engine import PROMPT_CLASS_NAMES, SEG_CLASS_NAMES

    os.makedirs(out_dir, exist_ok=True)
    entries = (app.demo_model_specs(device, only=only) if demo
               else app.load_family_models(models_dir, device, only=only))
    written = []
    for name, model, tsize, needs_prompt in entries:
        path = os.path.join(out_dir, f"{name}{ARTIFACT_EXT}")
        t0 = time.time()
        save_exported(path, model, tsize, name=name,
                      class_names=PROMPT_CLASS_NAMES if needs_prompt else SEG_CLASS_NAMES,
                      needs_prompt=needs_prompt, fast_transfer=fast_transfer)
        print(f"[export] {path} ({os.path.getsize(path)} bytes, traced on "
              f"{torch.device(device).type} in {time.time() - t0:.1f} s)")
        written.append(path)
    if not written:
        raise SystemExit(f"nothing exported from {models_dir!r}"
                         + (f" for model {only!r}" if only else ""))
    return written


def main(argv: Optional[Sequence[str]] = None) -> list:
    p = argparse.ArgumentParser(
        description="Export served families as torch.export programs that serve with "
                    "no model code")
    p.add_argument("--models-dir", default=None, help="directory of trained MO_<config> "
                                                      "checkpoints")
    p.add_argument("--demo", action="store_true", help="export the random-weight demo registry")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--model", default=None, help="export only this family")
    p.add_argument("--float32", action="store_true",
                   help="float32 in and out instead of uint8 in, bfloat16 out")
    p.add_argument("--device", default="cuda",
                   help="device to trace on, the device type the programs serve "
                        "(default cuda)")
    args = p.parse_args(argv)
    if not args.demo and not args.models_dir:
        raise SystemExit("--models-dir or --demo required")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to export programs for the CPU)")
    return export_registry(args.models_dir or "", args.out, only=args.model,
                           fast_transfer=not args.float32, demo=args.demo, device=args.device)


if __name__ == "__main__":
    main()
