"""The reference's own training and serving schedules, measured as anchors.

Counterpart of the JAX repository's benchmarks/reference_anchor.py. The
reference (in5omnia/Image_Segmentation) publishes no throughput, so a
speed-up needs a measured anchor. Three modes, one JSON line each:

  torch-cpu       the reference's stack on the host CPU: its UNet
                  (`reference_recipe.RefUNet`, base 64, 256 px) in eager
                  float32, micro-batch 2, (loss / 32).backward() per
                  micro-batch, AdamW every 32 (effective batch 64; reference
                  utils/training.py:18-64), unweighted CE + soft Dice, a
                  `loss.item()` per micro-batch (:58). With fewer than 32
                  steps the AdamW step's cost is charged pro rata, as JAX's
                  does;
  torch-serve     the reference webapp's request path (segmentation_webapp/
                  app.py:220-326), pinned to the CPU as it is (app.py:26):
                  resize+pad to 224, a batch-1 no_grad forward, the inverse
                  geometry back to 300 × 400, argmax; one request at a time;
  torch-samechip  the same training schedule on --device with the port's
                  own UNet (`models/unet.py`, float32, module path): micro-
                  batch 2, one backward a micro-batch, a `loss.item()` host
                  sync a micro-batch, one AdamW step every 32, Dice + CE.
                  The counterpart of JAX's jax-samechip: what the
                  reference's approach achieves on the card the port runs
                  on. The CPU runs base 8 at 64 px.

TF32 stays at PyTorch's defaults (what the reference's code gets on the
card); each line prints the setting it ran under.

    python -m image_segmentation_tpu_torch.probes.reference_anchor
        --mode torch-samechip|torch-cpu|torch-serve [--steps N] [--device cpu]

--device is where torch-samechip runs and whose card line is printed;
torch-cpu and torch-serve run on the host CPU whatever it says.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from image_segmentation_tpu_torch.probes import card_line, cli_device, stamp, sync
from image_segmentation_tpu_torch.probes.reference_recipe import (
    NUM_CLASSES,
    build_ref_unet,
    ref_dice_ce,
)

MICRO_BATCH = 2      # unet.ipynb cell 0: batch_size=2
ACCUM_STEPS = 32     # accumulation = 64 // batch_size (utils/training.py:49-56)
SIZE = 256           # TARGET_SIZE=256 for the UNet (unet.ipynb cell 0)
SERVE_SIZE = 224     # the webapp's TARGET_SIZE (app.py:26)


def _batch(size: int, nchw: bool, device="cpu"):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (MICRO_BATCH, size, size, 3)).astype("float32")
    y = rng.integers(0, NUM_CLASSES, (MICRO_BATCH, size, size)).astype("int64")
    x = torch.from_numpy(x.transpose(0, 3, 1, 2).copy() if nchw else x).to(device)
    return x, torch.from_numpy(y).to(device)


def run_torch_cpu(steps: int) -> dict:
    model = build_ref_unet()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
    x, y = _batch(SIZE, nchw=True)

    def micro_step(i):
        loss = ref_dice_ce(model(x), y)
        (loss / ACCUM_STEPS).backward()
        if (i + 1) % ACCUM_STEPS == 0:
            opt.step()
            opt.zero_grad()
        return float(loss.detach())

    micro_step(0)  # warm caches
    t0 = time.perf_counter()
    for i in range(steps):
        micro_step(i + 1)
    dt = time.perf_counter() - t0
    if steps < ACCUM_STEPS:
        # the AdamW step fell outside the window: charge its share
        t1 = time.perf_counter()
        opt.step()
        opt.zero_grad()
        dt += (time.perf_counter() - t1) * steps / ACCUM_STEPS
    return {"mode": "torch-cpu-eager-fp32", "images_per_sec": MICRO_BATCH * steps / dt,
            "micro_batch": MICRO_BATCH, "steps": steps}


def run_torch_serve(requests: int) -> dict:
    model = build_ref_unet().eval()
    t = SERVE_SIZE
    img = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (3, 300, 400))
                           .astype("float32"))

    def request(img):
        # resize_with_padding (utils/utils.py:13-49): the longer side to T,
        # bilinear, centred zero pad
        _, h, w = img.shape
        scale = t / max(h, w)
        nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
        resized = F.interpolate(img[None], size=(nh, nw), mode="bilinear", align_corners=False)
        pt, pl = (t - nh) // 2, (t - nw) // 2
        x = F.pad(resized, (pl, t - nw - pl, pt, t - nh - pt))
        with torch.no_grad():
            logits = model(x)
        # reverse_resize_and_padding (utils/utils.py:51-75) and argmax
        core = logits[:, :, pt:pt + nh, pl:pl + nw]
        back = F.interpolate(core, size=(h, w), mode="bilinear", align_corners=False)
        return back.argmax(dim=1).squeeze(0).numpy()

    request(img)  # warm
    lat = []
    for _ in range(requests):
        t0 = time.perf_counter()
        request(img)
        lat.append(time.perf_counter() - t0)
    p50 = statistics.median(lat)
    return {"mode": "torch-serve-cpu-batch1-224px", "p50_ms": p50 * 1e3,
            "spread_ms": [min(lat) * 1e3, max(lat) * 1e3], "requests_per_sec": 1.0 / p50,
            "requests": requests}


def samechip_model(device, base: int = 64):
    """The port's UNet in float32 on the module path, seeded, on `device`."""
    from image_segmentation_tpu_torch.models.unet import UNet

    model = UNet(num_classes=NUM_CLASSES, base=base, dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    return model.to(device=device, memory_format=torch.channels_last).train()


def samechip_window(model, opt, loss_fn, micros, accum: int, start: int = 0) -> list:
    """The reference's schedule over the (x, y) micro-batches `micros`,
    counted from micro-batch `start`: per micro-batch the forward, the loss,
    (loss / accum).backward() and a `loss.item()`; an optimizer step and
    zero_grad after every `accum`-th. Returns the losses."""
    losses = []
    for i, (x, y) in enumerate(micros, start):
        loss = loss_fn(model(x), y)
        (loss / accum).backward()
        losses.append(loss.item())
        if (i + 1) % accum == 0:
            opt.step()
            opt.zero_grad()
    return losses


def run_torch_samechip(steps: int, device) -> dict:
    from image_segmentation_tpu_torch.losses import DiceCELoss
    from image_segmentation_tpu_torch.train.state import make_adamw

    on_card = device.type == "cuda"
    model = samechip_model(device, 64 if on_card else 8)
    opt, _ = make_adamw(model.parameters(), learning_rate=1e-3, weight_decay=0.01)
    x, y = _batch(SIZE if on_card else 64, nchw=False, device=device)
    loss_fn = DiceCELoss()
    # warm: the last micro-batch of a window, so the optimizer step runs once
    samechip_window(model, opt, loss_fn, [(x, y)], ACCUM_STEPS, start=ACCUM_STEPS - 1)
    sync(device)
    t0 = time.perf_counter()
    samechip_window(model, opt, loss_fn, [(x, y)] * steps, ACCUM_STEPS)
    sync(device)
    dt = time.perf_counter() - t0
    return {"mode": "torch-samechip-fp32-microbatch2", "images_per_sec": MICRO_BATCH * steps / dt,
            "micro_batch": MICRO_BATCH, "accum_steps": ACCUM_STEPS, "steps": steps,
            "size": x.shape[1], "base": 64 if on_card else 8}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m image_segmentation_tpu_torch.probes.reference_anchor")
    p.add_argument("--mode", choices=["torch-cpu", "torch-serve", "torch-samechip"], required=True)
    p.add_argument("--steps", type=int, default=0, help="0 = the mode's default")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = cli_device(args.device)
    if args.mode == "torch-cpu":
        out = run_torch_cpu(args.steps or 4)
    elif args.mode == "torch-serve":
        out = run_torch_serve(args.steps or 12)
    else:
        out = run_torch_samechip(args.steps or 64, device)
    # the card line names the machine also where the mode ran on its CPU
    out = {**stamp(out, device if args.mode == "torch-samechip" else "cpu"),
           "card": card_line(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
