"""Reference-checkpoint import into the port (models/reference_import.py):
a torch state dict in the reference repository's layout goes through the
JAX package's importer (models/torch_import.py) into flax variables, and
through the port's importer into the port's model; the two eval forwards
on the same inputs must agree. The UNet and autoencoder state dicts are
built by tests/test_torch_import.py's own helpers; the ClipUNet's HF vision
tower is the port's ClipViT state dict under HF's names (no
`transformers` here), with the entries HF adds that both importers drop."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.models import (
    ReconstructionAutoencoder as JaxRecon,
    SegmentationAutoencoder as JaxSegAE,
    UNet as JaxUNet,
)
from image_segmentation_tpu.models import torch_import as TI
from image_segmentation_tpu.models.clip_unet import (
    ClipUNet as JaxClipUNet,
    ClipUNetNoSkips as JaxClipUNetNoSkips,
)
from image_segmentation_tpu.models.clip_vit import ClipViTConfig as JaxViTConfig
from image_segmentation_tpu.models.prompt import PromptModel as JaxPromptModel
from image_segmentation_tpu_torch import config as C
from image_segmentation_tpu_torch.models.clip_vit import ClipViT, ClipViTConfig
from image_segmentation_tpu_torch.models.reference_import import convert_reference_state_dict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_import import (  # noqa: E402
    BASE,
    _ae_state_dict,
    _reference_layout_state_dict,
)

torch.set_num_threads(1)

VIT = dict(image_size=32, patch_size=16, hidden_size=64, num_layers=4, num_heads=4,
           mlp_dim=128)
# f32 on both sides; the sums run in another order: the tolerances of
# tests/test_torch_import.py (5e-5 for the conv nets, 2e-4 through the ViT)
ATOL_CONV, ATOL_VIT = 5e-5, 2e-4


def _hf_clipunet_state_dict(seed: int, blocks, skips: bool):
    """A reference ClipUNet (clip/clipunet.py) or ClipUNetNoSkips state dict:
    the HF vision tower under encoder.clip_vit.vision_model (with HF's
    post_layernorm and position_ids), then the decoder."""
    vit = ClipViT(ClipViTConfig(**VIT))
    vit.init_weights(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sd = {f"encoder.clip_vit.vision_model.{k}": v.clone() for k, v in vit.state_dict().items()}
    sd["encoder.clip_vit.vision_model.post_layernorm.weight"] = torch.rand(64, generator=g)
    sd["encoder.clip_vit.vision_model.post_layernorm.bias"] = torch.rand(64, generator=g)
    sd["encoder.clip_vit.vision_model.embeddings.position_ids"] = torch.arange(5)[None]

    def conv(prefix, cout, cin, k, bias=True):
        sd[prefix + ".weight"] = torch.randn(cout, cin, k, k, generator=g) * (cin * k * k) ** -0.5
        if bias:
            sd[prefix + ".bias"] = torch.randn(cout, generator=g) * 0.1

    def bn(prefix, c):
        sd[prefix + ".weight"] = torch.rand(c, generator=g) + 0.5
        sd[prefix + ".bias"] = torch.randn(c, generator=g) * 0.1
        sd[prefix + ".running_mean"] = torch.randn(c, generator=g) * 0.1
        sd[prefix + ".running_var"] = torch.rand(c, generator=g) + 0.5
        sd[prefix + ".num_batches_tracked"] = torch.tensor(3)

    conv("decoder.init_conv", blocks[0][0], 64, 1)
    for i, (cin, cout) in enumerate(blocks):
        p = f"decoder.decoder_blocks.{i}"
        up = cin // 2 if skips else cin
        sd[f"{p}.upsample.weight"] = torch.randn(cin, up, 2, 2, generator=g) * cin**-0.5
        sd[f"{p}.upsample.bias"] = torch.randn(up, generator=g) * 0.1
        if skips:
            conv(f"{p}.skip_conv", up, 64, 1)
        conv(f"{p}.conv_block.0", cout, 2 * up if skips else up, 3, bias=False)
        bn(f"{p}.conv_block.1", cout)
        conv(f"{p}.conv_block.3", cout, cout, 3, bias=False)
        bn(f"{p}.conv_block.4", cout)
    conv("output_layer", 4, blocks[-1][1], 1)
    return sd


def _jax_forward(model, variables, *inputs):
    arrays = [jnp.asarray(x) for x in inputs]
    return np.asarray(model.apply(jax.tree.map(jnp.asarray, variables), *arrays, train=False))


def _port_forward(cfg, overrides, state, *inputs):
    model = C.build_model(cfg, "cpu", torch.Generator().manual_seed(0), **overrides)
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        return model(*(torch.from_numpy(x) for x in inputs)).numpy()


def _images(n, side, channels=3, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, side, side, channels)).astype(np.float32)


CLIP_BLOCKS = ((64, 32), (32, 16), (16, 8), (8, 8))


def _case(arch_case):
    """(reference state dict, arch, JAX model, JAX importer, the port's
    config and overrides, inputs, atol)."""
    if arch_case == "unet":
        sd = _reference_layout_state_dict(seed=11)
        return (sd, "unet", JaxUNet(num_classes=4, base=BASE), TI.convert_torch_unet_state_dict,
                C.UNET_NOAUG, dict(base=BASE), (_images(2, 64),), ATOL_CONV)
    if arch_case in ("autoencoder", "recon_ae"):
        seg = arch_case == "autoencoder"
        sd = _ae_state_dict(seg, seed=12)
        model = JaxSegAE(num_classes=4, base=BASE) if seg else JaxRecon(base=BASE)
        cfg = C.AUTOENCODER if seg else C.RECON_AE
        return (sd, "autoencoder", model, TI.convert_torch_autoencoder_state_dict, cfg,
                dict(base=BASE), (_images(2, 32),), ATOL_CONV)
    vit_j = JaxViTConfig(**VIT)
    chans = (64,) + tuple(c for _, c in CLIP_BLOCKS)
    if arch_case in ("clipunet", "clipunet_noskips"):
        skips = arch_case == "clipunet"
        sd = _hf_clipunet_state_dict(13, CLIP_BLOCKS, skips)
        if skips:
            model = JaxClipUNet(num_classes=4, vit=vit_j, skip_indices=(1, 2, 3, 4),
                                decoder_channels=chans)
            over = dict(vit=ClipViTConfig(**VIT), skip_indices=(1, 2, 3, 4),
                        decoder_channels=chans)
        else:
            model = JaxClipUNetNoSkips(num_classes=4, vit=vit_j, decoder_channels=chans)
            over = dict(vit=ClipViTConfig(**VIT), decoder_channels=chans)
        return (sd, "clipunet", model, TI.convert_torch_clipunet_state_dict,
                C.CLIPUNET if skips else C.CLIPUNET_NOSKIPS, over, (_images(2, 32),), ATOL_VIT)
    assert arch_case == "prompt"
    sd = {f"clip.{k}": v for k, v in _hf_clipunet_state_dict(14, CLIP_BLOCKS, True).items()}
    sd.update({f"mask.{k}": v
               for k, v in _reference_layout_state_dict(seed=15, din=4, dout=1).items()})
    model = JaxPromptModel(vit=vit_j, skip_indices=(1, 2, 3, 4), decoder_channels=chans,
                           unet_base=BASE)
    over = dict(vit=ClipViTConfig(**VIT), skip_indices=(1, 2, 3, 4), decoder_channels=chans,
                unet_base=BASE)
    return (sd, "prompt", model, TI.convert_torch_prompt_state_dict, C.PROMPT, over,
            (_images(2, 32), _images(2, 32, 1, seed=1)), ATOL_VIT)


@pytest.mark.parametrize("arch_case", ["unet", "autoencoder", "recon_ae", "clipunet",
                                       "clipunet_noskips", "prompt"])
def test_port_import_matches_jax_import(arch_case):
    """The same reference state dict, imported by JAX and by the port, gives
    the same eval forward; the port's detects the config from the keys."""
    sd, arch, jax_model, jax_convert, cfg, over, inputs, atol = _case(arch_case)
    state, got_cfg = convert_reference_state_dict(sd, arch)
    assert got_cfg == cfg
    want = _jax_forward(jax_model, jax_convert(sd), *inputs)
    got = _port_forward(cfg, over, state, *inputs)
    err = float(np.abs(got - want).max())
    print(f"{arch_case}: max |port - JAX| = {err:.3g} (atol {atol})")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_transpose_conv_is_not_flipped():
    """Torch on both sides: the reference's ConvTranspose2d weight arrives
    as it is (the flip belongs to the flax path)."""
    sd = _reference_layout_state_dict(seed=16)
    state, _ = convert_reference_state_dict(sd, "unet")
    for k in range(1, 5):
        assert torch.equal(state[f"up{k}.up.up.weight"], sd[f"up{k}.upsample.weight"])
    assert not any(k.endswith("num_batches_tracked") for k in state)


@pytest.mark.parametrize("arch_case", ["unet", "prompt"])
def test_accepts_full_checkpoint_wrapper(arch_case):
    """{'model_state_dict': ...} and the bare MO_ state dict give the same
    tensors (reference utils/training.py:564-609)."""
    sd, arch, *_ = _case(arch_case)
    bare, _ = convert_reference_state_dict(sd, arch)
    full, _ = convert_reference_state_dict({"model_state_dict": sd, "epoch": 3}, arch)
    assert bare.keys() == full.keys()
    assert all(torch.equal(bare[k], full[k]) for k in bare)


def test_cli_mo_is_served_by_models_dir(tmp_path, monkeypatch):
    """A reference full checkpoint → the CLI → MO_unet, which
    `build_engine_from_checkpoints` serves (widths narrowed to the
    checkpoint's base): the same masks as the port's UNet loaded with the
    importer's state, and the checkpoint's BN statistics in the model."""
    import dataclasses

    from image_segmentation_tpu_torch.serve import app
    from image_segmentation_tpu_torch.serve.engine import InferenceEngine
    from image_segmentation_tpu_torch.utils.convert_reference_weights import main

    sd = _reference_layout_state_dict(seed=17)
    pth = str(tmp_path / "ref.pth")
    torch.save({"model_state_dict": sd, "epoch": 12, "best_dev_miou": 0.7}, pth)
    models = tmp_path / "models"
    assert main(["--torch-checkpoint", pth, "--arch", "unet",
                 "--out", str(models / "MO_unet")]) == 0
    monkeypatch.setitem(app.FAMILY_SPECS, "unet",
                        dataclasses.replace(app.FAMILY_SPECS["unet"], target_size=64))
    build = app.build_model
    monkeypatch.setattr(app, "build_model",
                        lambda cfg, device, gen: build(cfg, device, gen, base=BASE))
    eng = app.build_engine_from_checkpoints(str(models), "cpu")
    assert eng.available() == ["unet"]

    state, cfg = convert_reference_state_dict(sd, "unet")
    model = C.build_model(cfg, "cpu", torch.Generator().manual_seed(1), base=BASE)
    model.load_state_dict(state, strict=True)
    np.testing.assert_array_equal(model.down1.conv1.bn.running_var.numpy(),
                                  sd["down1.doubleConvReLU.1.running_var"].numpy())
    ref = InferenceEngine("cpu")
    ref.register("unet", model, 64)
    img = np.random.default_rng(5).uniform(0, 1, (70, 50, 3)).astype(np.float32)
    np.testing.assert_array_equal(eng.segment(img, "unet")["mask"],
                                  ref.segment(img, "unet")["mask"])
