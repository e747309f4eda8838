"""Aug-vs-no-aug robustness through the reproduction pipeline (report PDF
§4.1, Fig. 6).

Counterpart of the JAX repository's benchmarks/robustness_pipeline.py.
It runs the real reproduction chain end to end on a pseudo-Pet tree,
`scripts/prepare_oxford_pet.py` → `scripts/reproduce_reference.py` for the
two UNet rows (unet_aug, unet_noaug; reference README.md:32-33), then
sweeps both best checkpoints on the Test split with the 8-perturbation ×
10-severity protocol of `studies/robustness.py` (its host path, as JAX's
pipeline does). The report's finding to reproduce: augmentation buys
robustness under perturbation more than clean-set accuracy.

Pseudo-Pet source (`make_pet_source`): variable-size JPEG scenes (noisy
textured background, a colour- and shape-coded "pet" with a trimap border
ring) in the Oxford-Pet download layout (images/ + annotations/trimaps/ +
list.txt), so the prepare script's species parsing, trimap conversion and
split all run for real.

  python -m image_segmentation_tpu_torch.studies.robustness_pipeline \
      [--images 240 --epochs 16 --batch 32 --target-size 256] [--out r.json]
  ... --images 12 --epochs 1 --target-size 32 --device cpu   # the CPU, small

The JSON holds JAX's fields; `device` is the card's name (or "cpu").
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from image_segmentation_tpu_torch.studies import cli_device, device_kind


def make_pet_source(src, n, seed=0, lo=120, hi=280):
    """Oxford-Pet-layout download tree of synthetic scenes.

    Learnable but not trivial: dark textured background, a colour-tinted
    pet (cats reddish, dogs greenish) with appearance jitter, and a bright
    border ring (trimap 3). The species is also shape-coded (cats
    elliptical, dogs diamond-shaped): with a colour cue alone a brightness
    shift destroys the class signal and neither arm can be robust; the
    shape cue gives augmentation something to move reliance onto, the
    report's mechanism. Stems follow the dataset's convention
    (capitalised = cat). The same `n` and `seed` give the tree the JAX
    repository's make_pet_source writes."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(src, "images")
    tri_dir = os.path.join(src, "annotations", "trimaps")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(tri_dir, exist_ok=True)
    lines = []
    for i in range(n):
        cat = bool(rng.integers(0, 2))
        stem = f"Synthcat_{i}" if cat else f"synthdog_{i}"
        h, w = int(rng.integers(lo, hi)), int(rng.integers(lo, hi))
        img = rng.uniform(0.05, 0.3, (h, w, 3)).astype(np.float32)
        # low-frequency background texture
        gy = np.linspace(0, 2 * np.pi * rng.uniform(1, 3), h)[:, None]
        gx = np.linspace(0, 2 * np.pi * rng.uniform(1, 3), w)[None, :]
        img += (0.05 * np.sin(gy + gx))[:, :, None]
        tri = np.full((h, w), 2, np.uint8)  # 2 = background
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.18, 0.33) * h, rng.uniform(0.18, 0.33) * w
        yy, xx = np.mgrid[0:h, 0:w]
        if cat:  # ellipse (L2 ball)
            d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        else:  # diamond (L1 ball)
            d = np.abs((yy - cy) / ry) + np.abs((xx - cx) / rx)
        blob, ring = d < 1.0, (d >= 1.0) & (d < 1.45)
        tint = np.array([0.75, 0.25, 0.2]) if cat else np.array([0.2, 0.75, 0.25])
        tint = tint + rng.uniform(-0.1, 0.1, 3)
        img[blob] = tint + rng.uniform(-0.08, 0.08, (int(blob.sum()), 3))
        img[ring] = rng.uniform(0.8, 1.0)
        tri[blob] = 1  # pet
        tri[ring] = 3  # border
        arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, stem + ".jpg"), quality=92)
        Image.fromarray(tri).save(os.path.join(tri_dir, stem + ".png"))
        lines.append(f"{stem} {i + 1} {1 if cat else 2} 1")
    with open(os.path.join(src, "annotations", "list.txt"), "w") as f:
        f.write("#stem class species breed\n" + "\n".join(lines) + "\n")


def prepare_tree(work: str, images: int) -> str:
    """{work}/src (make_pet_source) → {work}/tree (prepare, 0.15/0.15),
    unless the tree is there already; returns the tree."""
    from image_segmentation_tpu_torch.scripts import prepare_oxford_pet

    src, tree = os.path.join(work, "src"), os.path.join(work, "tree")
    if not os.path.isdir(os.path.join(tree, "Train")):
        make_pet_source(src, images)
        prepare_oxford_pet.main(["--src", src, "--dst", tree, "--val", "0.15",
                                 "--test", "0.15"])
    return tree


def materialize_test_split(tree: str, target_size: int):
    """The Test split materialised with its native-size labels kept."""
    from image_segmentation_tpu_torch.data.dataset import SegmentationDataset
    from image_segmentation_tpu_torch.data.labels import target_remap
    from image_segmentation_tpu_torch.data.loader import materialize

    test = SegmentationDataset(os.path.join(tree, "Test", "color"),
                               os.path.join(tree, "Test", "label"),
                               target_transform=target_remap)
    return materialize(test, target_size, keep_orig_labels=True)


def load_row_model(runs: str, row: str, device):
    """The row's best checkpoint ({runs}/{row}/{row}) in its config's model
    on `device`, in eval mode."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.train import checkpoint as ckpt

    model = C.build_model(C.CONFIGS[row], device, torch.Generator().manual_seed(0))
    model.load_state_dict(ckpt.load_model_state(os.path.join(runs, row, row), device))
    return model


def main(argv=None) -> dict:
    from image_segmentation_tpu_torch.scripts import reproduce_reference
    from image_segmentation_tpu_torch.studies.robustness import PERTURBATIONS, robustness_sweep
    from image_segmentation_tpu_torch.train.steps import eval_forward

    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.studies."
                                     "robustness_pipeline")
    p.add_argument("--images", type=int, default=240,
                   help="pseudo-Pet source size (split ~70/15/15)")
    p.add_argument("--epochs", type=int, default=16)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--target-size", type=int, default=256)
    p.add_argument("--workdir", default=None,
                   help="keep the tree and the runs here (default: a temp dir)")
    p.add_argument("--online-aug", action="store_true",
                   help="online device augmentation for the aug arm instead of the "
                        "reference's offline 8-augmenter pipeline. The report's "
                        "robustness claim is about the offline pipeline (grayscale, "
                        "Laplace noise, blur and linear contrast buy invariance to the "
                        "photometric families), so offline is the default")
    p.add_argument("--device", default="cuda",
                   help="torch device for every run and the sweep (default cuda)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    device = cli_device(args.device)

    t_all = time.time()
    work = args.workdir or tempfile.mkdtemp(prefix="robustness_pet_")
    tree = prepare_tree(work, args.images)
    runs = os.path.join(work, "runs")
    table = reproduce_reference.main([
        "--data-root", tree, "--save-dir", runs, "--rows", "unet_aug,unet_noaug",
        "--epochs", str(args.epochs), "--batch-size", str(args.batch),
        "--target-size", str(args.target_size), "--device", args.device,
        *([] if args.online_aug else ["--offline-aug"]),
        "--json-out", os.path.join(work, "table.json"),
    ])

    # both best checkpoints through the 8 x 10 sweep on the Test split
    val = materialize_test_split(tree, args.target_size)
    curves = {}
    for row in ("unet_aug", "unet_noaug"):
        model = load_row_model(runs, row, device)
        print(f"[sweep] {row}", flush=True)
        curves[row] = robustness_sweep(lambda x, _m=model: eval_forward(_m, x).float(), val,
                                       num_classes=4, device=device)

    # per-perturbation mean Dice over severities and the aug - noaug gap
    # (the report's direction: positive under most perturbations, larger
    # than the clean-set gap)
    mean_aug = {k: float(np.mean(v)) for k, v in curves["unet_aug"].items()}
    mean_no = {k: float(np.mean(v)) for k, v in curves["unet_noaug"].items()}
    gaps = {k: round(mean_aug[k] - mean_no[k], 4) for k in PERTURBATIONS}
    clean_gap = table["unet_aug"]["dice"] - table["unet_noaug"]["dice"]
    out = {
        "device": device_kind(device),
        "config": {"images": args.images, "epochs": args.epochs, "batch": args.batch,
                   "target_size": args.target_size},
        "clean_test": {r: table[r] for r in ("unet_aug", "unet_noaug")},
        "clean_dice_gap_aug_minus_noaug": round(clean_gap, 4),
        "curves": {r: {k: [round(d, 4) for d in v] for k, v in curves[r].items()}
                   for r in curves},
        "mean_dice_gap_aug_minus_noaug": gaps,
        "perturbations_where_aug_wins": sum(1 for g in gaps.values() if g > 0),
        "wall_s": round(time.time() - t_all, 1),
    }
    print(json.dumps({k: out[k] for k in (
        "clean_test", "clean_dice_gap_aug_minus_noaug", "mean_dice_gap_aug_minus_noaug",
        "perturbations_where_aug_wins", "wall_s")}, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
