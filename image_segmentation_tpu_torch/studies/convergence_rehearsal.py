"""Convergence parity rehearsal: the reference recipe against the port's
trainer, at the reference's width.

Counterpart of the JAX repository's benchmarks/convergence_rehearsal.py:

  model      a UNet at --base (64, the reference's width, unet/unet.py:80)
  data       the pseudo-Pet set (the ablations' hard synthetic scenes)
             expanded by the port's offline augmentation (data/augment.py,
             the reference's utils/augmentation.ipynb); both sides replay
             the same arrays in the same micro-batches
  geometry   resize+pad to --target-size (128)
  schedule   micro-batch 2, accumulation 4 (the reference's regime shape:
             (loss / k).backward() per micro-batch, a step every k;
             utils/training.py:49-56)
  length     ≥ 200 optimizer steps at the defaults (13 epochs × 16), the
             original-resolution eval after every epoch on both sides

The reference side is `probes/reference_recipe.py` in eager float32: its
torch UNet, its weighted Dice + CE, AdamW (lr 1e-3, wd 0.01), its host
eval. The port's side is `train_step(accum_steps=4)` on the port's UNet
in float32 with the device eval protocol (on the card through K1, in
bf16 on the same weights: the production eval). Both start
from the same weights: the reference UNet's torch initialisation, carried
into the port's layout. Both run on --device with TF32 off for the run
(float32 against float32, as JAX sets matmul precision to highest).

`analyze` derives the drift statistics and the checks from the recorded
curves alone: the first optimizer step's loss within 1e-3 relative, the
first epoch within 5e-2, both sides converged, and the final and last-3
eval metrics within the reference run's own late jitter (2× its
last-5-epoch std, at least 0.02). Past the first epoch two float
implementations decorrelate whatever their correctness, so converged
quality is the end-to-end check. It reads this module's artifacts
(`port_losses`, `port_evals`, checks `port_converged`) and the JAX
repository's (`jax_losses`, `jax_evals`, `jax_converged`).

    python -m image_segmentation_tpu_torch.studies.convergence_rehearsal
        [--epochs 13] [--images 128] [--base-images 48] [--base 64]
        [--target-size 128] [--out FILE] [--device cpu]
    python -m image_segmentation_tpu_torch.studies.convergence_rehearsal
        --recheck ARTIFACT --out FILE

--recheck re-derives the statistics of a saved artifact and writes the
result to --out (never over its input). The default --out is
`convergence_rehearsal/rehearsal.json` under the working directory.
Exits non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import time

import numpy as np
import torch

from image_segmentation_tpu_torch.studies import cli_device, device_kind

NUM_CLASSES = 4
WEIGHTS = (0.2047, 1.0272, 1.2293, 1.5388)  # FullWeight, unet.ipynb cell 0
LR, WD = 1e-3, 0.01
MICRO, ACCUM = 2, 4  # effective batch 8
DEFAULT_OUT = os.path.join("convergence_rehearsal", "rehearsal.json")


@contextlib.contextmanager
def float32_convs():
    """TF32 off for convs and matmuls while inside, restored after."""
    kept = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = kept


def rehearsal_data(images: int, base_images: int, target: int):
    """(train, val): the offline-augmented pseudo-Pet train set and 24 val
    scenes, as the JAX rehearsal builds them."""
    from image_segmentation_tpu_torch.data.augment import generate_augmented_dataset
    from image_segmentation_tpu_torch.data.dataset import ArrayDataset
    from image_segmentation_tpu_torch.data.labels import target_remap
    from image_segmentation_tpu_torch.data.loader import materialize
    from image_segmentation_tpu_torch.studies.ablations import hard_synthetic_items

    aug = generate_augmented_dataset(ArrayDataset(hard_synthetic_items(base_images, seed=11)),
                                     seed=0, size=target)
    order = np.random.default_rng(5).permutation(len(aug))[:images]
    train = materialize(ArrayDataset([(np.asarray(aug[i][0]), target_remap(np.asarray(aug[i][1])))
                                      for i in order]), target)
    val = materialize(ArrayDataset([(img, target_remap(lab))
                                    for img, lab in hard_synthetic_items(24, seed=99)]),
                      target, keep_orig_labels=True)
    return train, val


def schedule(train, epochs: int):
    """Per epoch, the (images, labels) micro-batches both sides replay."""
    n = len(train)
    steps = n // (MICRO * ACCUM)
    rng = np.random.default_rng(7)
    out = []
    for _ in range(epochs):
        perm = rng.permutation(n)[: steps * MICRO * ACCUM]
        out.append([(train.images[perm[s:s + MICRO]], train.labels[perm[s:s + MICRO]])
                    for s in range(0, len(perm), MICRO)])
    return out


def run_reference(model, micros_by_epoch, val, device) -> tuple:
    """The reference recipe: eager float32, (loss / k).backward() per
    micro-batch, AdamW every k, the host eval after each epoch."""
    from image_segmentation_tpu_torch.losses import DiceCELoss
    from image_segmentation_tpu_torch.probes.reference_recipe import ref_dice_ce, reference_eval

    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=WD)
    eval_cfg = DiceCELoss(class_weights=WEIGHTS, ignore_index=3)
    w = torch.tensor(WEIGHTS, device=device)
    losses, evals = [], []
    t0 = time.time()
    for ei, micros in enumerate(micros_by_epoch):
        model.train()
        acc = []
        opt.zero_grad()
        for i, (x, y) in enumerate(micros):
            x = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(device)
            loss = ref_dice_ce(model(x), torch.from_numpy(y.astype(np.int64)).to(device), w)
            (loss / ACCUM).backward()
            acc.append(float(loss.detach()))
            if (i + 1) % ACCUM == 0:
                opt.step()
                opt.zero_grad()
                losses.append(float(np.mean(acc)))
                acc = []
        evals.append(reference_eval(model, val, eval_cfg))
        print(f"[reference] epoch {ei}: loss={losses[-1]:.4f} eval={evals[-1]} "
              f"({time.time() - t0:.0f}s)", flush=True)
    return losses, evals


def kernel_eval_state(state, device):
    """The state the port's eval runs: on the card the production eval path,
    K1 in bf16 on the same parameters and statistics (a shallow copy of the
    float32 UNet with bf16 compute and the kernels on; K1 takes bf16);
    elsewhere the state itself."""
    from image_segmentation_tpu_torch.train.state import TrainState

    if device.type != "cuda":
        return state
    twin = copy.copy(state.model)  # shares the submodules, so every tensor
    twin.dtype, twin.use_kernels = torch.bfloat16, True
    return TrainState(twin)


def run_port(state, micros_by_epoch, val, device) -> tuple:
    """The port's trainer: `train_step` with accum_steps over micro-batch 2,
    the device eval protocol after each epoch (`kernel_eval_state`)."""
    from image_segmentation_tpu_torch.losses import DiceCELoss
    from image_segmentation_tpu_torch.train.loop import evaluate
    from image_segmentation_tpu_torch.train.steps import train_step

    train_cfg = DiceCELoss(class_weights=WEIGHTS)
    eval_cfg = DiceCELoss(class_weights=WEIGHTS, ignore_index=3)
    losses, evals = [], []
    t0 = time.time()
    for ei, micros in enumerate(micros_by_epoch):
        for s in range(0, len(micros), ACCUM):
            xs = np.concatenate([micros[s + j][0] for j in range(ACCUM)])
            ys = np.concatenate([micros[s + j][1] for j in range(ACCUM)])
            loss = train_step(state, train_cfg, torch.from_numpy(xs).to(device),
                              torch.from_numpy(ys.astype(np.int64)).to(device), ACCUM)
            losses.append(float(loss))
        evals.append(evaluate(kernel_eval_state(state, device), val, loss_cfg=eval_cfg,
                              protocol="device", verbose=False))
        print(f"[port] epoch {ei}: loss={losses[-1]:.4f} eval={evals[-1]} "
              f"({time.time() - t0:.0f}s)", flush=True)
    return losses, evals


def analyze(artifact: dict) -> dict:
    """Drift statistics and checks, pure over the recorded curves (JAX
    convergence_rehearsal.py `analyze`, :258-326). The compared side is the
    port's (`port_*`) or, on a JAX artifact, JAX's (`jax_*`), and its
    convergence check takes its name."""
    side = "port" if "port_losses" in artifact else "jax"
    t_arr = np.asarray(artifact["torch_losses"])
    j_arr = np.asarray(artifact[f"{side}_losses"])
    t_evals, j_evals = artifact["torch_evals"], artifact[f"{side}_evals"]
    spe = len(t_arr) // len(t_evals)  # steps per epoch
    rel = np.abs(j_arr - t_arr) / (np.abs(t_arr) + 1e-3)
    keys = ("dice", "iou", "acc")
    per_epoch = {k: [abs(float(je[k]) - float(te[k])) for te, je in zip(t_evals, j_evals)]
                 for k in keys}
    jitter = {k: float(np.std([float(e[k]) for e in t_evals[-5:]])) for k in keys}
    final_delta = {k: per_epoch[k][-1] for k in per_epoch}
    last3_delta = {k: abs(float(np.mean([float(e[k]) for e in t_evals[-3:]]))
                          - float(np.mean([float(e[k]) for e in j_evals[-3:]])))
                   for k in keys}
    tol = {k: max(0.02, 2.0 * jitter[k]) for k in jitter}
    checks = {
        "torch_converged": bool(float(t_evals[-1]["dice"]) > 0.75 and t_arr[-1] < 0.5 * t_arr[0]),
        f"{side}_converged": bool(float(j_evals[-1]["dice"]) > 0.75
                                  and j_arr[-1] < 0.5 * j_arr[0]),
        "first_step_rel_lt_1e-3": bool(rel[0] < 1e-3),
        "first_epoch_rel_lt_5e-2": bool(rel[:spe].max() < 5e-2),
        "final_dice_within_ref_jitter": bool(final_delta["dice"] < tol["dice"]),
        "final_iou_within_ref_jitter": bool(final_delta["iou"] < tol["iou"]),
        "final_acc_within_ref_jitter": bool(final_delta["acc"] < tol["acc"]),
        "last3_dice_within_ref_jitter": bool(last3_delta["dice"] < tol["dice"]),
        "last3_iou_within_ref_jitter": bool(last3_delta["iou"] < tol["iou"]),
    }
    return {
        "rel_drift": {"first_step": float(rel[0]), "first_epoch_max": float(rel[:spe].max()),
                      "max": float(rel.max()), "argmax_step": int(rel.argmax()),
                      "median": float(np.median(rel))},
        "eval_deltas": {"per_epoch_abs": per_epoch, "final_abs": final_delta,
                        "last3_mean_abs": last3_delta, "ref_last5_jitter_std": jitter,
                        "tolerance_2x_jitter_floor_0.02": tol},
        "checks": checks,
        "ok": all(checks.values()),
    }


REPORT = ("rel_drift", "eval_deltas", "checks", "ok")


def recheck(path: str, out: str) -> dict:
    """`analyze` of the artifact at `path`, written with it to `out`."""
    if os.path.abspath(path) == os.path.abspath(out):
        raise ValueError(f"--recheck writes to --out, never over its input {path}")
    with open(path) as f:
        artifact = json.load(f)
    artifact.pop("eval_deltas_max_abs", None)
    artifact.pop("eval_loss_rel_max", None)
    artifact.update(analyze(artifact))
    _write(out, artifact)
    print(json.dumps({k: artifact[k] for k in REPORT}, indent=1))
    return artifact


def _write(path: str, obj: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _round(e: dict) -> dict:
    return {k: (np.asarray(v).tolist() if np.ndim(v) else float(v)) for k, v in e.items()}


def rehearse(args, device) -> dict:
    from image_segmentation_tpu_torch.models.unet import UNet
    from image_segmentation_tpu_torch.probes.reference_recipe import (
        build_ref_unet,
        port_state_dict,
    )
    from image_segmentation_tpu_torch.train.state import TrainState, make_adamw

    t_all = time.time()
    target = args.target_size
    train, val = rehearsal_data(args.images, args.base_images, target)
    n = len(train)
    steps_per_epoch = n // (MICRO * ACCUM)
    n_opt_steps = steps_per_epoch * args.epochs
    print(f"train={n} augmented images, {steps_per_epoch} opt-steps/epoch, {n_opt_steps} total",
          flush=True)
    micros = schedule(train, args.epochs)

    ref = build_ref_unet(args.base)
    model = UNet(num_classes=NUM_CLASSES, base=args.base, dtype=torch.float32)
    model.load_state_dict(port_state_dict(ref))
    model = model.to(device=device, memory_format=torch.channels_last)
    opt, _ = make_adamw(model.parameters(), learning_rate=LR, weight_decay=WD)
    with float32_convs():
        t_losses, t_evals = run_reference(ref.to(device), micros, val, device)
        p_losses, p_evals = run_port(TrainState(model, opt), micros, val, device)
    out = {
        "config": {"base": args.base, "T": target, "micro": MICRO, "accum_steps": ACCUM,
                   "epochs": args.epochs, "train_images": n, "opt_steps": n_opt_steps,
                   "augmented": True, "lr": LR, "wd": WD, "weights": WEIGHTS,
                   "device": device_kind(device)},
        "torch_losses": t_losses, "port_losses": p_losses,
        "torch_evals": [_round(e) for e in t_evals], "port_evals": [_round(e) for e in p_evals],
        "wall_s": time.time() - t_all,
    }
    out.update(analyze(out))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m image_segmentation_tpu_torch.studies.convergence_rehearsal")
    p.add_argument("--images", type=int, default=128,
                   help="augmented train-set size (after expansion)")
    p.add_argument("--base-images", type=int, default=48)
    p.add_argument("--epochs", type=int, default=13)
    p.add_argument("--base", type=int, default=64)
    p.add_argument("--target-size", type=int, default=128)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--recheck", default=None, metavar="ARTIFACT",
                   help="re-derive the statistics of a saved artifact into --out")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    if args.recheck:
        return recheck(args.recheck, args.out)
    device = cli_device(args.device)
    out = rehearse(args, device)
    _write(args.out, out)
    print(json.dumps({k: out[k] for k in REPORT + ("wall_s",)}), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
