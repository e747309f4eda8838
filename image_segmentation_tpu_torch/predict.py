"""Offline batch prediction CLI: segment a directory (or one file) of
images with a trained or demo registry and write class-id and
colourised masks.

Counterpart of image_segmentation_tpu/predict.py: the serving pipeline
(resize+pad to the model's target, the device forward, the inverse
geometry at the original resolution, argmax, colourise) as a batch tool,
optionally scored against ground-truth labels with the reference's
original-resolution protocol (macro Dice/IoU/Acc with the ignore class
left out). Runs on the card unless `--device cpu`; JAX's `--mesh` is not
ported. Without PIL, images and labels must be PNG, and JPEG is refused
(`data/png.py`).

Usage:
  python -m image_segmentation_tpu_torch.predict --models-dir runs/ \
      --model unet --input photos/ --output out/ [--labels labels/]
  python -m image_segmentation_tpu_torch.predict --demo --input photos/ --output out/
  # prompt models: one point prompt applied to every image
  python -m image_segmentation_tpu_torch.predict --demo --model prompt_model \
      --input photos/ --output out/ --point 120,80
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def list_inputs(path: str) -> List[str]:
    """A single image file, or every image in a directory (sorted by
    stem, the reference's dataset ordering)."""
    if os.path.isfile(path):
        return [path]
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    files = [os.path.join(path, f) for f in sorted(os.listdir(path))
             if f.lower().endswith(IMAGE_EXTS)]
    if not files:
        raise FileNotFoundError(f"no {'/'.join(IMAGE_EXTS)} files in {path}")
    return files


def load_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] with the datasets' channel rules (alpha
    dropped, gray replicated)."""
    from image_segmentation_tpu_torch.data.dataset import (
        _decode_image,
        normalize_image_channels,
    )

    return normalize_image_channels(_decode_image(path)).astype(np.float32) / 255.0


def load_label(path: str, prompt_space: bool = False) -> np.ndarray:
    """(H, W) int32 class ids in the scored model's label space: the
    255 → boundary remap for segmentation models; the prompt task's
    {0 deactivated, 1 bg + boundary, 2 cat, 3 dog} for prompt models, so
    labels and predictions share a space."""
    from image_segmentation_tpu_torch.data.dataset import _decode_image
    from image_segmentation_tpu_torch.data.labels import remap_for_prompt_task, target_remap

    arr = _decode_image(path)[..., 0].astype(np.int32)
    return remap_for_prompt_task(arr) if prompt_space else target_remap(arr)


def _write_png(path: str, arr: np.ndarray) -> None:
    from image_segmentation_tpu_torch.data.png import encode_png

    with open(path, "wb") as f:
        f.write(encode_png(arr))


def predict_paths(engine, model_name: str, paths: Sequence[str],
                  output_dir: Optional[str] = None, labels_dir: Optional[str] = None,
                  point: Optional[Tuple[int, int]] = None, ignore_index: Optional[int] = 3,
                  verbose: bool = True) -> Dict:
    """Segment `paths` through `engine`'s `model_name`; write
    `{stem}_mask.png` (class ids) and `{stem}_color.png` into output_dir;
    where labels_dir holds `{stem}.png`, score with the original-resolution
    protocol. Returns the summary (JAX's keys; NaN is JSON null)."""
    from image_segmentation_tpu_torch.metrics.confusion import MetricsHistory
    from image_segmentation_tpu_torch.serve.render import create_prompt_mask

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    entry = engine.models[model_name]
    if entry.needs_prompt and point is None:
        raise SystemExit(f"model {model_name!r} is prompt-based: --point X,Y is required "
                         "(an empty prompt would deactivate every pixel)")
    if not entry.needs_prompt and point is not None and verbose:
        print(f"[predict] note: {model_name!r} takes no prompt; --point is ignored")
    num_classes = len(entry.class_names)
    agg = MetricsHistory(num_classes=num_classes, ignore_index=ignore_index)
    scored = 0
    seg_times: List[float] = []
    for path in paths:
        image = load_image(path)
        prompt_mask = None
        if entry.needs_prompt:
            prompt_mask = create_prompt_mask("points", [{"x": point[0], "y": point[1]}],
                                             image.shape[:2])
        t0 = time.perf_counter()
        result = engine.segment(image, model_name, prompt_mask)
        seg_times.append(time.perf_counter() - t0)
        stem = os.path.splitext(os.path.basename(path))[0]
        if output_dir:
            _write_png(os.path.join(output_dir, f"{stem}_mask.png"), result["mask"])
            _write_png(os.path.join(output_dir, f"{stem}_color.png"), result["color_mask"])
        label_path = os.path.join(labels_dir, f"{stem}.png") if labels_dir else None
        if label_path and os.path.isfile(label_path):
            label = load_label(label_path, prompt_space=entry.needs_prompt)
            if label.shape != result["mask"].shape:
                raise ValueError(f"{label_path}: label shape {label.shape} does not match "
                                 f"image {result['mask'].shape}")
            bad = (label < 0) | (label >= num_classes)
            if bad.any():
                raise ValueError(
                    f"{label_path}: label values outside the {num_classes}-class space "
                    f"(found {sorted(np.unique(label[bad]).tolist())[:8]}); expected "
                    "class-id PNGs (0..C-1 with the 255 boundary sentinel)")
            agg.accumulate(result["mask"], label)
            scored += 1
        if verbose:
            print(f"[predict] {stem}: {result['mask'].shape}")
    # steady state: the first segment() call pays the warm-up (the kernels'
    # build and first launches on a card), so it is left out where there
    # is more than one image
    steady = seg_times[1:] if len(seg_times) > 1 else seg_times
    summary: Dict = {
        "model": model_name,
        "images": len(paths),
        "images_per_sec": round(len(steady) / max(sum(steady), 1e-9), 3),
        "first_image_s": round(seg_times[0], 3),
        "class_names": list(entry.class_names),
    }
    if scored:
        dice, iou, acc = agg.compute_epoch_metrics()

        def _num(v):  # NaN (a class absent from labels and predictions) → null
            return round(float(v), 4) if np.isfinite(v) else None

        summary.update(scored=scored, mean_dice=_num(dice), mean_iou=_num(iou),
                       mean_acc=_num(acc),
                       per_class_iou=[_num(v) for v in agg.get_last_per_class_iou()])
    return summary


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True, help="image file or directory of .jpg/.png")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--models-dir", default=None,
                   help="directory of trained MO_<config> checkpoints")
    p.add_argument("--demo", action="store_true", help="random-weight registry (smoke testing)")
    p.add_argument("--model", default=None,
                   help="registry model name (default: sole model, else 'unet')")
    p.add_argument("--labels", default=None,
                   help="directory of {stem}.png ground-truth class-id labels to score "
                        "against (original-resolution protocol)")
    p.add_argument("--point", default=None,
                   help="X,Y point prompt in original-image pixels (prompt models)")
    p.add_argument("--ignore-index", type=int, default=None,
                   help="class left out of the macro average. Default: 3 (boundary, the "
                        "reference protocol) for segmentation models, none for prompt "
                        "models, whose label space has no boundary class; -1 disables")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions of the "
                        "kernels)")
    args = p.parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to predict on the CPU)")
    from image_segmentation_tpu_torch.serve.app import (
        build_demo_engine,
        build_engine_from_checkpoints,
    )

    if args.demo or not args.models_dir:
        print("[predict] demo mode: random-weight models")
        engine = build_demo_engine(args.device)
    else:
        engine = build_engine_from_checkpoints(args.models_dir, args.device)
    names = engine.available()
    model = args.model or ("unet" if "unet" in names else names[0])
    if model not in names:
        raise SystemExit(f"unknown model {model!r}; available: {names}")
    point = None
    if args.point:
        x, y = (int(v) for v in args.point.split(","))
        point = (x, y)
    if args.ignore_index is None:
        ignore_index = None if engine.models[model].needs_prompt else 3
    else:
        ignore_index = None if args.ignore_index < 0 else args.ignore_index
    summary = predict_paths(engine, model, list_inputs(args.input), output_dir=args.output,
                            labels_dir=args.labels, point=point, ignore_index=ignore_index)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
