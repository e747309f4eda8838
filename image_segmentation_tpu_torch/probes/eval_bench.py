"""Original-resolution eval throughput: the device protocol against the
host protocol.

Counterpart of the JAX repository's benchmarks/eval_bench.py. The
reference evaluates every epoch at each image's native resolution
(reference utils/training.py:67-121). `train.loop.evaluate` does it two
ways: `protocol="host"` runs the forward on the device, then per image
the inverse geometry, the float64 loss (`losses/host.py`) and the
confusion on the host; `protocol="device"` keeps the inverse, the argmax,
the masked loss and the confusion on the device (train/fast_eval.py, in
canvas-size buckets) and fetches a (C, C) matrix and the losses a batch.
Both forwards are the UNet's eval forward, which on the card runs K1
nine times a batch.

This probe times both on one synthetic set (UNet-64, bf16, 256 px on the
card; base 8, float32, 64 px and 8 images on the CPU) and
prints one JSON line a protocol, then a summary: whether the metrics are
bit-identical and whether they match the float64 host oracle within 1e-4.
With --pet-like the native sizes follow the Oxford-IIIT Pet test split
(the bulk at 500 × 250..400 in either orientation, a tail down to 150 px,
1% up to 1000 px); without it they are uniform 200..500 (48..96 on the
CPU). The device
line also gives the canvas-size bucket plan the eval used.

    python -m image_segmentation_tpu_torch.probes.eval_bench [--images 128]
        [--pet-like] [--protocols device,host] [--out FILE] [--device cpu]

The first protocol runs once untimed first (cuDNN's and K1's first
calls, the device copy of the val set); each timed run is one evaluate.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from image_segmentation_tpu_torch.probes import cli_device, device_kind, stamp

NUM_CLASSES = 4


class _SyntheticPet:
    """Variable-size (img, label) pairs with Pet-like native sizes; the
    same arrays as the JAX probe's for the same arguments. `min_side` is
    the uniform sizes' lower end, which JAX fixes at 200 (so its CPU sizes,
    max_side 96, raise there)."""

    def __init__(self, n: int, seed: int = 0, max_side: int = 500, pet_like: bool = False,
                 min_side: int = 200):
        rng = np.random.default_rng(seed)
        self.sizes = []
        for _ in range(n):
            if not pet_like:
                self.sizes.append((int(rng.integers(min_side, max_side)),
                                   int(rng.integers(min_side, max_side))))
                continue
            u = rng.uniform()
            if u < 0.01:  # rare large outliers
                h, w = int(rng.integers(600, 1000)), int(rng.integers(600, 1000))
            elif u < 0.70:  # the max-side-500 bulk
                long, short = 500, int(rng.integers(250, 400))
                h, w = (long, short) if rng.uniform() < 0.5 else (short, long)
            else:  # smaller-image tail
                h, w = int(rng.integers(150, 500)), int(rng.integers(150, 500))
            self.sizes.append((h, w))

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, i):
        h, w = self.sizes[i]
        rng = np.random.default_rng(1000 + i)
        img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        label = rng.integers(0, 4, (h, w)).astype(np.int32)
        return img, label


def _canvas(orig_labels, multiple=8):
    hc = max(-(-l.shape[0] // multiple) * multiple for l in orig_labels)
    wc = max(-(-l.shape[1] // multiple) * multiple for l in orig_labels)
    return [int(hc), int(wc)]


def _bucket_plan_summary(val):
    """Canvas sizes and image counts of the plan evaluate() used."""
    views = val.bucket_views
    if not views:
        return [{"images": len(val), "canvas": _canvas(val.orig_labels)}]
    return [{"images": len(v), "canvas": _canvas(v.orig_labels)} for v in views]


def sizes(device) -> dict:
    """The probe's sizes on `device`: full width on the card, the JAX
    probe's CPU sizes elsewhere."""
    if torch.device(device).type == "cuda":
        return dict(target=256, min_side=200, max_side=500, base=64, dtype=torch.bfloat16)
    return dict(target=64, min_side=48, max_side=96, base=8, dtype=torch.float32)


def setup(n: int, pet_like: bool, device, use_kernels: bool = True):
    """(materialised val set, TrainState of a seeded UNet, staging s) at the
    probe's sizes on `device`; the kernels only on a card."""
    from image_segmentation_tpu_torch.data.loader import materialize
    from image_segmentation_tpu_torch.models.unet import UNet
    from image_segmentation_tpu_torch.train.state import TrainState

    device = torch.device(device)
    sz = sizes(device)
    t0 = time.perf_counter()
    val = materialize(_SyntheticPet(n, max_side=sz["max_side"], pet_like=pet_like,
                                    min_side=sz["min_side"]),
                      sz["target"], keep_orig_labels=True)
    staging_s = time.perf_counter() - t0
    model = UNet(num_classes=NUM_CLASSES, base=sz["base"], dtype=sz["dtype"],
                 use_kernels=use_kernels and device.type == "cuda")
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.to(device=device, memory_format=torch.channels_last)
    return val, TrainState(model), staging_s


def measure(state, val, protocols, batch: int):
    """Each protocol's evaluate on `val`, the first one run once before the
    timed runs. Returns (the JAX probe's rows, each protocol's metrics)."""
    from image_segmentation_tpu_torch.losses import DiceCELoss
    from image_segmentation_tpu_torch.losses.host import dice_ce_loss_np
    from image_segmentation_tpu_torch.train.loop import evaluate

    loss_cfg = DiceCELoss(ignore_index=3)
    device = next(state.model.parameters()).device
    rows, metrics = [], {}
    for i, protocol in enumerate(protocols):
        kwargs = dict(num_classes=NUM_CLASSES, batch_size=batch, verbose=False,
                      protocol=protocol)
        if protocol == "host":
            kwargs["host_loss_fn"] = lambda lg, lb: dice_ce_loss_np(lg, lb, loss_cfg)
        else:
            kwargs["loss_cfg"] = loss_cfg
        if i == 0:
            evaluate(state, val, **kwargs)
        t0 = time.perf_counter()
        m = evaluate(state, val, **kwargs)
        dt = time.perf_counter() - t0
        metrics[protocol] = m
        rows.append(stamp({
            "metric": f"orig_res_eval_images_per_sec_{protocol}",
            "value": len(val) / dt, "unit": "images/sec", "images": len(val),
            "dice": float(m["dice"]), "miou": float(m["iou"]), "val_loss": float(m["loss"]),
            "wall_s": dt}, device))
        if protocol == "device":
            rows[-1]["bucket_plan"] = _bucket_plan_summary(val)
    return rows, metrics


def summarize(metrics: dict) -> dict:
    """The JAX probe's comparison of the two protocols' metrics. Confusion
    counts are integers on both paths, so a delta means some pixels' argmax
    flipped between the device inverse (float32) and the host's; random
    weights on noise images sit at near-ties everywhere, so a few flips are
    expected there."""
    if not ("device" in metrics and "host" in metrics):
        return {}
    d, h = metrics["device"], metrics["host"]
    out = {"metrics_bit_identical": bool(float(d["dice"]) == float(h["dice"])
                                         and float(d["iou"]) == float(h["iou"])),
           "dice_delta": abs(float(d["dice"]) - float(h["dice"])),
           "miou_delta": abs(float(d["iou"]) - float(h["iou"])),
           "loss_delta": abs(float(d["loss"]) - float(h["loss"]))}
    out["metrics_match_host_oracle"] = bool(out["dice_delta"] < 1e-4 and out["miou_delta"] < 1e-4
                                            and out["loss_delta"] < 1e-4)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.probes.eval_bench")
    p.add_argument("--images", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--protocols", default="device,host")
    p.add_argument("--pet-like", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = cli_device(args.device)
    n = args.images if device.type == "cuda" else 8

    val, state, staging_s = setup(n, args.pet_like, device)
    rows, metrics = measure(state, val, args.protocols.split(","), args.batch)
    for row in rows:
        print(json.dumps(row), flush=True)
    summary = {"staging_s": staging_s, "pet_like": args.pet_like, **summarize(metrics)}
    print(json.dumps(summary), flush=True)
    out = {"device": device_kind(device), "rows": rows, **summary}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
