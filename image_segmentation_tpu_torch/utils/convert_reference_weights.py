"""Convert a checkpoint trained with the reference repository into an
`MO_` directory of the port.

The port's counterpart of scripts/convert_unet_weights.py. It takes
either artifact the reference writes (utils/training.py:564-609): a full
checkpoint {'model_state_dict': ..., 'optimizer_state_dict': ...} or a
weights-only `MO_` state dict, maps it with
`models/reference_import.py` (parameters and BatchNorm running
statistics) and writes the port's weights-only artifact
(`train/checkpoint.save_params_only`). Name the output after the config
it prints, and `--models-dir` serves it:

  python -m image_segmentation_tpu_torch.utils.convert_reference_weights \
      --torch-checkpoint MO_UNet_ref.pth --arch unet --out runs/models/MO_unet
  python -m image_segmentation_tpu_torch.serve.app --models-dir runs/models
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from image_segmentation_tpu_torch.models.reference_import import ARCHS

    p = argparse.ArgumentParser(prog="python -m image_segmentation_tpu_torch.utils."
                                     "convert_reference_weights")
    p.add_argument("--torch-checkpoint", required=True,
                   help=".pth file: a full reference checkpoint or a bare MO_ state dict")
    p.add_argument("--arch", default="unet", choices=ARCHS,
                   help="source architecture: unet (reference unet/unet.py), autoencoder "
                        "(either stage, read from the keys), clipunet (clip/clipunet.py or "
                        "the no-skips variant, read from the keys), prompt "
                        "(prompt_based/prompt.py)")
    p.add_argument("--out", required=True,
                   help="the MO_ directory to write (MO_<config> for --models-dir)")
    args = p.parse_args(argv)

    import torch

    from image_segmentation_tpu_torch.models.reference_import import (
        convert_reference_state_dict,
    )
    from image_segmentation_tpu_torch.train.checkpoint import save_params_only

    # a reference checkpoint also pickles its optimizer state and metrics
    sd = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=False)
    state, cfg = convert_reference_state_dict(sd, args.arch)
    save_params_only(args.out, state)
    n = sum(v.numel() for k, v in state.items() if not k.endswith(("running_mean",
                                                                    "running_var")))
    print(f"wrote {args.out}: {n / 1e6:.1f}M parameters + BN statistics of config "
          f"{cfg.name!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
