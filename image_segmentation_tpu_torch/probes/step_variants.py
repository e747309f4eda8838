"""Controlled variants of the UNet train step, timed in interleaved turns.

Counterpart of the JAX repository's benchmarks/step_variants.py: images/s
of the 256 px, batch 128, bf16 UNet-64 step (4 × 64², base 8, float32 on
the CPU) for variants that each change one thing, all from the same
initial weights on the same batch:

  base       the production step: `train_step`, DiceCELoss(ignore_index=3)
  fusedloss  one log_softmax shared by the Dice (as its exp) and the CE,
             the same math as DiceCELoss(ignore_index=3). (The JAX probe's
             FusedDiceCE passes no ignore index to its CE, so it is not the
             loss it claims to equal on labels holding class 3; this one is.)
  bf16stats  BatchNorm's batch mean and variance taken on the bf16
             activations (E[x²] − E[x]² in bf16); the port's train BN is
             one fused pass with float32 accumulation. A numerics
             experiment: its quality is not validated
  dts        each transpose conv as a 1×1 conv to 4·C channels and a
             depth-to-space, its weights relabelled so that it computes
             the transpose conv exactly
  remat      each DoubleConv under torch.utils.checkpoint (non-reentrant):
             its activations are recomputed in the backward. The recompute
             runs BatchNorm's forward again; its running statistics are
             restored after it, so they move once a step, as in base (and
             as under flax's nn.remat)

Each variant lives here: none is an option of the model or the trainer.
Each turn times --steps synchronised steps of every variant in order;
the medians over --turns turns and their spread are printed.

    python -m image_segmentation_tpu_torch.probes.step_variants
        [--variants base,fusedloss,bf16stats,dts,remat] [--steps 10]
        [--turns 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.losses.cross_entropy import _nll_from_logp
from image_segmentation_tpu_torch.losses.dice import soft_dice_loss
from image_segmentation_tpu_torch.models.layers import (
    BN_EPS,
    BN_MOMENTUM,
    BatchNorm,
    ConvBNRelu,
    UpConv,
)
from image_segmentation_tpu_torch.probes import (
    cli_device,
    interleaved,
    production_step,
    stamp,
)

VARIANTS = ("base", "fusedloss", "bf16stats", "dts", "remat")
IGNORE_INDEX = 3


class FusedDiceCE:
    """DiceCELoss(ignore_index=3) with one log_softmax: the Dice takes its
    exp, the CE its values."""

    def __call__(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits.float(), dim=-1)
        d = soft_dice_loss(logp.exp(), targets, apply_softmax=False, ignore_index=IGNORE_INDEX)
        return d + _nll_from_logp(logp, targets, None, IGNORE_INDEX, logits.shape[-1])


class Bf16StatsBatchNorm(BatchNorm):
    """The port's BatchNorm with its train-mode batch statistics taken in
    bf16 (flax's `_compute_stats` forced to bf16, as the JAX probe does);
    the normalisation and the running update stay float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xb, dims, shape = x.to(torch.bfloat16), (0, 2, 3), (1, -1, 1, 1)
        mean = xb.mean(dims)
        var = ((xb * xb).mean(dims) - mean * mean).clamp_min(0)
        mean, var = mean.float(), var.float()
        y = ((x.float() - mean.view(shape)) * (torch.rsqrt(var + BN_EPS) * self.weight).view(shape)
             + self.bias.view(shape))
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
            self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        return y.to(x.dtype)


class DtsUpConv(nn.Module):
    """A 2×2 stride-2 transpose conv as a 1×1 conv to 4·C_out channels and
    `pixel_shuffle(2)`. pixel_shuffle reads channel c·4 + 2·i + j into
    output pixel (2h + i, 2w + j) of channel c, so the 1×1 weight's row
    c·4 + 2·i + j is the transpose conv's weight[:, c, i, j] and each
    output channel's bias repeats 4 times."""

    def __init__(self, up: UpConv):
        super().__init__()
        w, b = up.up.weight, up.up.bias  # (C_in, C_out, 2, 2), (C_out,)
        cin, cout = w.shape[:2]
        self.conv = nn.Conv2d(cin, 4 * cout, 1).to(w.device)
        with torch.no_grad():
            self.conv.weight.copy_(w.permute(1, 2, 3, 0).reshape(4 * cout, cin, 1, 1))
            self.conv.bias.copy_(b.repeat_interleave(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.conv.weight.to(x.dtype), self.conv.bias.to(x.dtype))
        return F.pixel_shuffle(y, 2)


class Remat(nn.Module):
    """`block` under non-reentrant activation checkpointing, its
    BatchNorms' running statistics restored after the backward's
    recompute."""

    def __init__(self, block: nn.Module):
        super().__init__()
        self.block = block

    @contextlib.contextmanager
    def _keep_running_stats(self):
        bns = [m for m in self.block.modules() if isinstance(m, BatchNorm)]
        kept = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
        try:
            yield
        finally:
            with torch.no_grad():
                for m, (mean, var) in zip(bns, kept):
                    m.running_mean.copy_(mean)
                    m.running_var.copy_(var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not torch.is_grad_enabled():
            return self.block(x)
        return checkpoint(self.block, x, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              self._keep_running_stats()))


def make_variant(name: str, base: nn.Module):
    """(a copy of the UNet `base` changed as `name` says, its loss)."""
    if name not in VARIANTS:
        raise ValueError(f"variant {name!r} not in {VARIANTS}")
    model = copy.deepcopy(base)
    if name == "bf16stats":
        for m in model.modules():
            if isinstance(m, ConvBNRelu):
                bn = Bf16StatsBatchNorm(m.bn.weight.numel()).to(m.bn.weight.device)
                bn.load_state_dict(m.bn.state_dict())
                m.bn = bn
    elif name == "dts":
        for up in (model.up1, model.up2, model.up3, model.up4):
            up.up = DtsUpConv(up.up)
    elif name == "remat":
        model.down1 = Remat(model.down1)
        for block in (model.down2, model.down3, model.down4, model.down5,
                      model.up1, model.up2, model.up3, model.up4):
            block.conv = Remat(block.conv)
    return model, FusedDiceCE() if name == "fusedloss" else DiceCELoss(ignore_index=IGNORE_INDEX)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.probes.step_variants")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--turns", type=int, default=2)
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
    from image_segmentation_tpu_torch.train.steps import train_step

    device = cli_device(args.device)
    base, x, y, _ = production_step(device, args.batch, args.size)
    steps = {}
    for name in args.variants.split(","):
        model, loss = make_variant(name, base.model)
        state = TrainState(model, make_adamw(model.parameters(), learning_rate=1e-3)[0])
        steps[name] = lambda state=state, loss=loss: train_step(state, loss, x, y)
    del base
    times = interleaved(steps, args.steps, args.turns, device)
    results = {}
    for name, t in times.items():
        results[name] = x.shape[0] / (t.ms / 1e3)
        print(json.dumps({name: results[name], "step_ms": t.ms,
                          "spread_ms": [t.min_ms, t.max_ms]}), flush=True)
    out = stamp({"img_per_sec": results, "batch": x.shape[0], "size": x.shape[1],
                 "steps": args.steps, "turns": args.turns}, device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
