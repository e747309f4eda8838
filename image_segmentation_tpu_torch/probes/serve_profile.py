"""Where a single UNet request's time goes, stage by stage.

Counterpart of the JAX repository's benchmarks/serve_profile.py. One
300 × 400 request to a UNet-64 at 256 px (bf16, K1 in the forward, on
the card; base 8, float32, 64 px on the CPU), each stage timed alone,
medians over --steps (5 on the CPU) with their spread:

  stage          host resize+pad and uint8 packing (serve/engine.py
                 `stage_request`)
  upload         the packed input to the device (the engine's pinned,
                 non-blocking copy and uint8 decode), synchronised
  forward        the model's eval forward on the uploaded input under
                 inference mode, synchronised
  fetch          `InferenceEngine.fetch` of the forward's bf16 scores:
                 the copy back into pinned memory
  forward_fetch  `ModelEntry.dispatch` and `InferenceEngine.fetch`: the
                 request's device half, upload included
  unstage        host inverse geometry, argmax and colourising
                 (`unstage_result`)
  e2e            `InferenceEngine.segment`, the whole request

The split of the four families' host time under load is
`serve/profiling.py`'s; this probe splits one UNet stream.

    python -m image_segmentation_tpu_torch.probes.serve_profile [--steps 40]
        [--size 256] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from image_segmentation_tpu_torch.probes import cli_device, stamp, sync, timed

IMAGE_HW = (300, 400)


def build(size: int, device, use_kernels: bool = True):
    """(engine with the seeded UNet registered as "unet", the model) at the
    probe's sizes on `device`: base 64 in bf16 with K1 on a card, base 8 in
    float32 elsewhere."""
    from image_segmentation_tpu_torch.models.unet import UNet
    from image_segmentation_tpu_torch.serve.engine import InferenceEngine

    device = torch.device(device)
    on_card = device.type == "cuda"
    model = UNet(num_classes=4, base=64 if on_card else 8,
                 dtype=torch.bfloat16 if on_card else torch.float32,
                 use_kernels=use_kernels and on_card)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(device=device, memory_format=torch.channels_last)
    engine = InferenceEngine(device)
    engine.register("unet", model, target_size=size)
    return engine, model


def image(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (*IMAGE_HW, 3)).astype(np.float32)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.probes.serve_profile")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    from image_segmentation_tpu_torch.serve.engine import stage_request, unstage_result

    device = cli_device(args.device)
    on_card = device.type == "cuda"
    size = args.size if on_card else 64
    steps = args.steps if on_card else 5
    engine, model = build(size, device)
    entry = engine.models["unet"]
    img = image()

    engine.segment(img, "unet")  # warm-up: cuDNN plans, the allocator, K1's first call
    inputs, meta = stage_request(img, entry, None, engine.fast_transfer)
    batch = [x[None] for x in inputs]
    x_dev = engine._to_device(batch[0])
    dispatched = entry.dispatch(*batch)
    scores = engine.fetch(*dispatched)[0]

    def forward():
        with torch.inference_mode():
            return model(x_dev)

    stages = {
        "stage": lambda: stage_request(img, entry, None, engine.fast_transfer),
        "upload": lambda: engine._to_device(batch[0]),
        "forward": forward,
        "fetch": lambda: engine.fetch(*dispatched),
        "forward_fetch": lambda: engine.fetch(*entry.dispatch(*batch)),
        "unstage": lambda: unstage_result(scores, meta, entry),
        "e2e": lambda: engine.segment(img, "unet"),
    }
    out = {}
    for name, fn in stages.items():
        out.update(timed(fn, steps, device).row(name))
    sync(device)
    out = stamp({**out, "steps": steps, "size": size, "image_hw": list(IMAGE_HW)}, device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
