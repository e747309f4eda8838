"""The reference's training recipe in torch: its UNet, its loss and its
original-resolution eval, as the anchors and the rehearsals run them.

The port's own copy of what the JAX repository keeps in
benchmarks/reference_anchor.py (`_build_ref_unet`, :50-93) and in its
tests (`_torch_dice_ce` and `_TorchRefUNet`, tests/test_trajectory_
parity.py:48-110; `_torch_reference_eval`, tests/test_convergence_parity.
py:105). The UNet is the reference's topology (reference unet/unet.py:
4-105) in torch's own modules and initialisation: a double-conv stem,
four max pool + double-conv downs, four transpose-conv ups with the skip
concatenated first, a 1×1 head. `RefUNet` keeps reference_anchor.py's
layout (`stem`, `downs`, `ups_t`, `ups_c`, `head`), so that file's state
dict loads into it; `reference_layout` renames its entries to the
reference's checkpoint layout, which `models.reference_import` maps onto
the port's UNet. Its BatchNorm is torch's: the running variance takes the
unbiased batch variance, where the port's (and flax's) takes the biased
one. Train-mode forwards never read it, so a trajectory is unaffected;
an eval is, slightly.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_segmentation_tpu_torch.losses.host import dice_ce_loss_np
from image_segmentation_tpu_torch.metrics import MetricsHistory
from image_segmentation_tpu_torch.models.reference_import import unet_state_dict
from image_segmentation_tpu_torch.ops import geometry as G

NUM_CLASSES = 4
# FullWeight class weights (reference unet.ipynb cell 0)
FULL_WEIGHTS = (0.2047, 1.0272, 1.2293, 1.5388)


def _dconv(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(
        nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.ReLU(),
        nn.Conv2d(cout, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.ReLU(),
    )


class RefUNet(nn.Module):
    """The reference UNet (NCHW in, NCHW logits out) at channels
    base·{1, 2, 4, 8, 16}."""

    def __init__(self, base: int = 64, num_classes: int = NUM_CLASSES, in_channels: int = 3):
        super().__init__()
        chans = [base * 2**i for i in range(5)]
        self.stem = _dconv(in_channels, chans[0])
        self.downs = nn.ModuleList(
            nn.Sequential(nn.MaxPool2d(2, 2), _dconv(chans[i], chans[i + 1]))
            for i in range(4)
        )
        self.ups_t = nn.ModuleList(
            nn.ConvTranspose2d(chans[i + 1], chans[i], 2, stride=2)
            for i in reversed(range(4))
        )
        self.ups_c = nn.ModuleList(
            _dconv(chans[i + 1], chans[i]) for i in reversed(range(4))
        )
        self.head = nn.Conv2d(chans[0], num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [self.stem(x)]
        for d in self.downs:
            feats.append(d(feats[-1]))
        y = feats[-1]
        for t, c, skip in zip(self.ups_t, self.ups_c, reversed(feats[:-1])):
            y = c(torch.cat([skip, t(y)], dim=1))
        return self.head(y)


def build_ref_unet(base: int = 64, seed: int = 0) -> RefUNet:
    """A RefUNet in torch's default initialisation, drawn from the CPU
    generator seeded `seed` (the caller's generator state is kept):
    reference_anchor.py's `_build_ref_unet()` at base 64 and seed 0."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return RefUNet(base)


def reference_layout(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A RefUNet state dict under the reference's checkpoint names
    (down1.doubleConvReLU, downK.maxpool_doubleConv.1.doubleConvReLU,
    upK.upsample, upK.doubleConv.doubleConvReLU, output)."""
    out = {}
    for key, v in sd.items():
        top, rest = key.split(".", 1)
        if top == "stem":
            key = f"down1.doubleConvReLU.{rest}"
        elif top == "downs":
            i, rest = rest.split(".", 1)
            key = f"down{int(i) + 2}.maxpool_doubleConv.{rest[:2]}doubleConvReLU.{rest[2:]}"
        elif top == "ups_t":
            i, rest = rest.split(".", 1)
            key = f"up{int(i) + 1}.upsample.{rest}"
        elif top == "ups_c":
            i, rest = rest.split(".", 1)
            key = f"up{int(i) + 1}.doubleConv.doubleConvReLU.{rest}"
        elif top == "head":
            key = f"output.{rest}"
        out[key] = v
    return out


def port_state_dict(model: RefUNet) -> Dict[str, torch.Tensor]:
    """The RefUNet's weights and BatchNorm statistics as the port's UNet
    state dict (any base)."""
    return unet_state_dict(reference_layout(model.state_dict()))


def ref_dice_ce(logits: torch.Tensor, y: torch.Tensor,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's loss (utils/weighted_loss.py:6-166) on NCHW logits:
    batch-aggregate soft Dice (class-weighted mean, negated) plus the
    weighted-mean CE, unit weights. Without `w` both are unweighted, which
    is reference_anchor.py's `ce(pred, y) + soft_dice(pred, y)`."""
    if w is None:
        w = torch.ones(logits.shape[1], device=logits.device)
    p = torch.softmax(logits, 1)
    oh = F.one_hot(y, logits.shape[1]).permute(0, 3, 1, 2).float()
    inter = (p * oh).sum((0, 2, 3))
    denom = p.sum((0, 2, 3)) + oh.sum((0, 2, 3))
    dc = (2.0 * inter + 1e-5) / torch.clamp(denom + 1e-5, min=1e-8)
    dice = -(dc * w).sum() / w.sum()
    return dice + F.cross_entropy(logits, y, weight=w)


def reference_eval(model: nn.Module, val, loss_cfg, batch_size: int = 8) -> dict:
    """The reference eval protocol (utils/training.py:67-121) on an NCHW
    torch model: eval-mode forward of the staged inputs, the float64 host
    inverse to each image's native size, the loss and the confusion there
    against the untouched labels. `val` is materialised with
    keep_orig_labels; returns loss, dice, iou and acc. The model's mode is
    restored after."""
    device = next(model.parameters()).device
    agg = MetricsHistory(NUM_CLASSES, ignore_index=3)
    losses, outs = [], []
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for s in range(0, len(val), batch_size):
                x = torch.from_numpy(val.images[s:s + batch_size]).to(device)
                outs.append(model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).cpu().numpy())
    finally:
        model.train(was_training)
    out = np.concatenate(outs)
    for i, meta in enumerate(G.metas_to_list(val.metas)):
        inv = G.invert_resize_padding_np(out[i], meta, method="linear")
        lab = val.orig_labels[i]
        losses.append(dice_ce_loss_np(inv, lab, loss_cfg))
        idx = lab.astype(np.int64) * NUM_CLASSES + inv.argmax(axis=-1).astype(np.int64)
        agg.accumulate_confusion(np.bincount(idx.reshape(-1), minlength=NUM_CLASSES**2)
                                 .reshape(NUM_CLASSES, NUM_CLASSES))
    dice, iou, acc = agg.compute_epoch_metrics()
    return {"loss": float(np.mean(losses)), "dice": dice, "iou": iou, "acc": acc}
