"""Ablation harness: the reference report's controlled comparisons.

Counterpart of the JAX repository's benchmarks/ablations.py. The reference
report (PDF §4) is built around controlled comparisons; each gets a
reproducible run here (the real-data magnitudes wait for Oxford-Pet; the
directions are checkable on the hard synthetic task below):

  loss        weighted CE + SoftDice vs weighted CE alone (report: CE +
              SoftDice wins)
  weights     FullWeight (inverse frequency over all 4 classes) vs
              MinWeight (boundary pinned to the smallest weight) vs
              unweighted (report: FullWeight > MinWeight for the UNet)
  skips       ClipUNet vs ClipUNetNoSkips, both frozen on the same
              pretrained narrow encoder (report: skips win). Stage 0
              pretrains the encoder with a linear per-patch probe on its
              last layer, on a shifted distribution of the task, so the
              frozen comparison runs at non-trivial quality
  resolution  256 px vs 512 px UNet (report: 512 ≈ 256 at ~4x the step
              cost); the card only
  prompt_freeze  PromptModel with the ClipUNet branch frozen (reference
              prompt_based/prompt.py:30-31) vs fine-tuned (webapp; report
              Fig. 8h: fine-tuning won), both from the same trained ClipUNet

The task is deliberately harder than the runner's synthetic set (which
any config solves): small objects (~6% of pixels, heavy class imbalance),
low contrast, pixel noise and a true boundary ring labelled 255.

  python -m image_segmentation_tpu_torch.studies.ablations [--experiments loss,weights]
      [--epochs 12 --images 128] [--out ablations.json] [--device cpu]

One JSON line per run ({"experiment", "variant", "best_dice", "best_miou",
"steady_epoch_s"}) and one summary line per experiment naming the winner.

The sizes follow --device: the card runs --images/--epochs/--batch/--base
at 256 px (a 224 px ViT of --vit-hidden and --vit-layers), the CPU 16
images, 2 epochs, batch 8, base 8 at 64 px (a 64 px ViT of hidden 32 and 4
layers), as JAX's accelerator and CPU sizes. On the card the UNets'
evals run K1, and the frozen ViT of the skips and prompt_freeze arms runs
K3 and K4; stage 0 trains its ViT on the plain path, since the kernels
have no backward. K3 takes a head dim of 64, so on the card the ViT has
hidden/64 heads (2 at the default hidden 128; JAX uses 4 heads of 32).
"""
from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_segmentation_tpu_torch.studies import cli_device, device_kind

NUM_CLASSES = 4


def hard_synthetic_items(n: int, seed: int = 0, *, obj_lo: int = 10, obj_hi: int = 4,
                         contrast=(0.15, 0.3), noise: float = 0.08, bg=(0.35, 0.12)):
    """Small low-contrast objects with boundary rings: a task where class
    imbalance and the boundary class matter. The keyword knobs define
    shifted distributions of the same family (object size h//obj_lo ..
    h//obj_hi, contrast range, pixel noise, background mean and std), which
    the skips ablation pretrains its encoder on. The same `n` and `seed`
    give the JAX repository's items."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        h = int(rng.integers(160, 320))
        w = int(rng.integers(160, 320))
        img = rng.normal(bg[0], bg[1], (h, w, 3)).astype(np.float32)
        label = np.zeros((h, w), np.int32)
        for _obj in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(1, 3))
            oh = int(rng.integers(h // obj_lo, h // obj_hi))
            ow = int(rng.integers(w // obj_lo, w // obj_hi))
            y0 = int(rng.integers(0, h - oh))
            x0 = int(rng.integers(0, w - ow))
            yy, xx = np.ogrid[:h, :w]
            cy, cx = y0 + oh / 2, x0 + ow / 2
            ellipse = ((yy - cy) / (oh / 2)) ** 2 + ((xx - cx) / (ow / 2)) ** 2
            inner = ellipse <= 1.0
            ring = (ellipse <= 1.35) & ~inner
            label[inner] = cls
            label[ring & (label == 0)] = 255  # boundary sentinel
            img[inner, cls - 1] += float(rng.uniform(*contrast))
        img += rng.normal(0, noise, img.shape).astype(np.float32)
        items.append((np.clip(img, 0, 1), label))
    return items


def _dataset(n, target, seed, keep_orig=False, items_kw=None):
    from image_segmentation_tpu_torch.data.dataset import ArrayDataset
    from image_segmentation_tpu_torch.data.labels import target_remap
    from image_segmentation_tpu_torch.data.loader import materialize

    items = [(i, target_remap(l)) for i, l in hard_synthetic_items(n, seed, **(items_kw or {}))]
    return materialize(ArrayDataset(items), target, keep_orig_labels=keep_orig)


def _weights(train, scheme):
    from image_segmentation_tpu_torch.data.labels import calculate_class_weights

    if scheme == "none":
        return None
    # MinWeight (reference utils/utils.py:189-191): the boundary (3) pinned
    # to the smallest weight
    kw = dict(unimportant_class_indices=[3]) if scheme == "min" else {}
    w = calculate_class_weights([np.asarray(l) for l in train.labels], NUM_CLASSES, **kw)
    return tuple(float(x) for x in w)


class PatchProbe(nn.Module):
    """Stage 0 of the skips ablation: a ViT with a linear per-patch readout
    (a 1x1 conv on the last layer's token grid, bilinearly upsampled), so
    that supervision enters only through the ViT's last layer and the head
    shares no architecture with either arm. The ViT runs the plain path:
    it trains, and the kernels have no backward."""

    def __init__(self, vit, dtype: torch.dtype = torch.float32):
        super().__init__()
        from image_segmentation_tpu_torch.models.clip_vit import ClipViT

        self.vit, self.dtype = vit, dtype
        self.vision_model = ClipViT(vit, use_kernels=False)
        self.probe = nn.Conv2d(vit.hidden_size, NUM_CLASSES, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from image_segmentation_tpu_torch.models.clip_vit import tokens_to_grid

        last, _ = self.vision_model(x.to(self.dtype))
        grid = tokens_to_grid(last, self.vit.grid_size).float().permute(0, 3, 1, 2)
        logits = F.interpolate(self.probe(grid), size=x.shape[1:3], mode="bilinear",
                               align_corners=False)
        return logits.permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "PatchProbe":
        from image_segmentation_tpu_torch.models.layers import init_conv1x1_

        self.vision_model.init_weights(generator)
        init_conv1x1_(self.probe, generator)
        return self


def _run(model, train, val, loss_cfg, epochs, batch, label, *, device, frozen=(), patch=None):
    """Train one variant; returns (result row, final TrainState).

    `patch` is a state dict of pretrained entries (names as the model's)
    loaded over the random init before training, the ablation's analogue
    of a pretrained checkpoint. `frozen` are prefixes kept out of the
    optimizer (no update, no weight decay) and out of autograd, as run.py
    freezes an encoder."""
    from image_segmentation_tpu_torch.train.loop import fit
    from image_segmentation_tpu_torch.train.state import (
        TrainState,
        freeze_,
        make_adamw,
        trainable_parameters,
    )

    model.init_weights(torch.Generator().manual_seed(0))
    if patch:
        missing = set(patch) - set(model.state_dict())
        if missing:
            raise KeyError(f"patch entries the model lacks: {sorted(missing)[:4]}")
        model.load_state_dict(patch, strict=False)
    model = model.to(device=device, memory_format=torch.channels_last)
    freeze_(model, frozen)
    opt, _ = make_adamw(trainable_parameters(model, frozen), learning_rate=1e-3)
    with tempfile.TemporaryDirectory() as d:
        res = fit(TrainState(model, opt), train, val, loss_fn=loss_cfg, epochs=epochs,
                  batch_size=batch, save_dir=d, name="abl", eval_loss_cfg=loss_cfg,
                  verbose=False)
    et = res.history["epoch_time_s"]
    steady = et[-1] if len(et) < 3 else float(np.median(et[1:]))
    out = {"experiment": label[0], "variant": label[1],
           "best_dice": round(float(res.best["dice"]), 4),
           "best_miou": round(float(res.best["miou"]), 4),
           "steady_epoch_s": round(steady, 3)}
    print(json.dumps(out), flush=True)
    return out, res.state


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.studies.ablations")
    p.add_argument("--experiments", default="loss,weights,skips,resolution,prompt_freeze")
    p.add_argument("--images", type=int, default=128)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--base", type=int, default=32,
                   help="UNet base width (32 separates the configs at a fraction of "
                        "the base-64 cost)")
    p.add_argument("--out", default=None,
                   help="write every row and each experiment's summary to this JSON file")
    p.add_argument("--clip-pre-epochs", type=int, default=None,
                   help="encoder-pretrain epochs (default 10x --epochs: a conv-free ViT "
                        "needs about an order of magnitude more steps than the UNet)")
    p.add_argument("--clip-epochs", type=int, default=None,
                   help="CLIP/prompt arm epochs (default 3x --epochs)")
    p.add_argument("--vit-hidden", type=int, default=128)
    p.add_argument("--vit-layers", type=int, default=6)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs JAX's CPU sizes)")
    args = p.parse_args(argv)
    device = cli_device(args.device)

    from image_segmentation_tpu_torch.losses import DiceCELoss
    from image_segmentation_tpu_torch.models.unet import UNet

    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    n = args.images if on_card else 16
    epochs = args.epochs if on_card else 2
    batch = args.batch if on_card else 8
    base = args.base if on_card else 8
    side = 256 if on_card else 64
    # explicit None checks: an intentional 0 stays 0
    pre_epochs = (args.clip_pre_epochs if args.clip_pre_epochs is not None
                  else 10 * epochs) if on_card else epochs
    clip_epochs = (args.clip_epochs if args.clip_epochs is not None
                   else 3 * epochs) if on_card else epochs

    def unet():
        return UNet(num_classes=NUM_CLASSES, base=base, dtype=dtype, use_kernels=on_card)

    train = _dataset(n, side, seed=0)
    val = _dataset(max(16, n // 4), side, seed=1, keep_orig=True)
    full_w = _weights(train, "full")
    picked = args.experiments.split(",")
    results = []
    run = lambda *a, **kw: _run(*a, device=device, **kw)  # noqa: E731

    if "loss" in picked:
        for variant, dw in (("ce", 0.0), ("dice_ce", 1.0)):
            results.append(run(unet(), train, val,
                               DiceCELoss(dice_weight=dw, class_weights=full_w),
                               epochs, batch, ("loss", variant))[0])

    if "weights" in picked:
        for scheme in ("none", "min", "full"):
            results.append(run(unet(), train, val,
                               DiceCELoss(class_weights=_weights(train, scheme)),
                               epochs, batch, ("weights", scheme))[0])

    clip_trained = None  # (state of the trained skips ClipUNet, vit, chans)
    vit = None
    if "skips" in picked or "prompt_freeze" in picked:
        from image_segmentation_tpu_torch.models.clip_unet import ClipUNet, ClipUNetNoSkips
        from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig

        # A narrow ViT at --smoke-vit's patch geometry, pretrained (stage 0)
        # rather than random: a random frozen encoder puts both arms in a
        # noise regime. The pretext is decoder-agnostic (a linear per-patch
        # probe, sharing no architecture with either arm) and runs on a
        # shifted distribution of the task (larger, higher-contrast
        # objects, calmer background), as CLIP's pretraining differs from
        # the transfer task.
        size = 224 if on_card else 64
        hid = args.vit_hidden if on_card else 32
        # K3 takes head dim 64: hidden/64 heads on the card, JAX's 4 on the CPU
        heads = max(1, hid // 64) if on_card else 4
        # at least 4 layers: the skips arm taps hidden states 1..4
        vit = ClipViTConfig(image_size=size, patch_size=16, hidden_size=hid,
                            num_layers=args.vit_layers if on_card else 4,
                            num_heads=heads, mlp_dim=2 * hid)
        chans = tuple(max(8, 64 >> i) for i in range(5))
        t224 = _dataset(n, size, seed=0)
        v224 = _dataset(max(16, n // 4), size, seed=1, keep_orig=True)
        loss = DiceCELoss(class_weights=full_w)
        shift = dict(obj_lo=6, obj_hi=3, contrast=(0.3, 0.5), noise=0.05, bg=(0.5, 0.1))
        pre_t = _dataset(n, size, seed=50, items_kw=shift)
        pre_v = _dataset(max(16, n // 4), size, seed=51, keep_orig=True, items_kw=shift)
        _, pre_state = run(PatchProbe(vit, dtype), pre_t, pre_v, loss, pre_epochs, batch,
                           ("skips", "encoder_pretrain(linear-probe,shifted)"))
        enc = {k: v for k, v in pre_state.model.state_dict().items()
               if k.startswith("vision_model.")}
        del pre_state

        for variant, model in (
            ("skips", ClipUNet(num_classes=NUM_CLASSES, vit=vit, skip_indices=(1, 2, 3, 4),
                               decoder_channels=chans, dtype=dtype, use_kernels=on_card)),
            ("noskips", ClipUNetNoSkips(num_classes=NUM_CLASSES, vit=vit,
                                        decoder_channels=chans, dtype=dtype,
                                        use_kernels=on_card)),
        ):
            row, st = run(model, t224, v224, loss, clip_epochs, batch, ("skips", variant),
                          frozen=("vision_model",), patch=enc)
            if "skips" in picked:
                results.append(row)
            if variant == "skips":
                clip_trained = (st, chans)

    if "prompt_freeze" in picked:
        # Both arms start from the same trained ClipUNet (grafted as run.py
        # --clipunet-checkpoint does); the ViT inside stays frozen in both
        # (the reference never unfreezes it, clip/clipunet.py:28-30).
        from image_segmentation_tpu_torch.data.dataset import ArrayDataset
        from image_segmentation_tpu_torch.data.loader import materialize
        from image_segmentation_tpu_torch.data.prompts import generate_prompt_dataset
        from image_segmentation_tpu_torch.losses import DiceNLLLoss
        from image_segmentation_tpu_torch.models.prompt import PromptModel

        st, chans = clip_trained
        size = vit.image_size
        pt = materialize(generate_prompt_dataset(
            ArrayDataset(hard_synthetic_items(n, seed=0)), seed=0), size)
        pv = materialize(generate_prompt_dataset(
            ArrayDataset(hard_synthetic_items(max(16, n // 4), seed=1)), seed=1),
            size, keep_orig_labels=True)
        clip_patch = {f"clip.{k}": v for k, v in st.model.state_dict().items()}
        for variant, freeze in (("frozen", True), ("finetuned", False)):
            row, _ = run(PromptModel(num_classes=NUM_CLASSES, freeze_clip=freeze, vit=vit,
                                     skip_indices=(1, 2, 3, 4), decoder_channels=chans,
                                     unet_base=base, dtype=dtype, use_kernels=on_card),
                         pt, pv, DiceNLLLoss(), clip_epochs, batch,
                         ("prompt_freeze", variant),
                         frozen=("clip",) if freeze else ("clip.vision_model",),
                         patch=clip_patch)
            results.append(row)

    if "resolution" in picked and on_card:
        t512 = _dataset(n, 512, seed=0)
        v512 = _dataset(max(16, n // 4), 512, seed=1, keep_orig=True)
        results.append(run(unet(), t512, v512, DiceCELoss(class_weights=full_w), epochs,
                           max(4, batch // 4), ("resolution", "512px"))[0])
        # the 256 px weights/full run doubles as the 256 px arm; run it here
        # when the weights experiment was not picked
        if "weights" not in picked:
            results.append(run(unet(), train, val, DiceCELoss(class_weights=full_w), epochs,
                               batch, ("resolution", "256px"))[0])

    by_exp = {}
    for r in results:
        by_exp.setdefault(r["experiment"], []).append(r)
    summaries = []
    for exp, rs in by_exp.items():
        best = max(rs, key=lambda r: r["best_miou"])
        summaries.append({"summary": exp, "winner": best["variant"],
                          "miou": {r["variant"]: r["best_miou"] for r in rs},
                          "epoch_s": {r["variant"]: r["steady_epoch_s"] for r in rs}})
        print(json.dumps(summaries[-1]), flush=True)
    out = {
        "device": device_kind(device),
        "config": {"images": n, "epochs": epochs, "batch": batch, "base": base,
                   "target": side, "clip_pre_epochs": pre_epochs, "clip_epochs": clip_epochs,
                   "vit_hidden": args.vit_hidden, "vit_layers": args.vit_layers,
                   "vit_heads": vit.num_heads if vit is not None else None},
        "rows": results,
        "summaries": summaries,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
