"""The CLIP family through the port's run CLI on the CPU (`--smoke-vit
--synthetic 16 --target-size 64 --device cpu`): `clipunet` with
`--clip-weights`, its resume, `--cache-features`, `clipunet_noskips`,
`prompt --clipunet-checkpoint`, and `--evaluate` on each config's `MO_`;
a 3-step `clipunet` fit against JAX's `fit` on the same data and
weights; and the checkpoints of a cached-feature run, which hold the
whole ClipUNet in the port, where JAX's hold the decoder alone (a
reference-side defect, stated here)."""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu import config as JC
from image_segmentation_tpu import run as jax_run
from image_segmentation_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from image_segmentation_tpu.data.loader import materialize as jax_materialize
from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
from image_segmentation_tpu.models.clip_unet import ClipUNet as JaxClipUNet
from image_segmentation_tpu.models.clip_vit import ClipViTConfig as JaxViTConfig
from image_segmentation_tpu.models.prompt import PromptModel as JaxPromptModel
from image_segmentation_tpu.ops import geometry as jax_geometry
from image_segmentation_tpu.train import checkpoint as jax_ckpt
from image_segmentation_tpu.train import create_train_state
from image_segmentation_tpu.train import loop as jax_loop
from image_segmentation_tpu.train.state import subtree_mask
from image_segmentation_tpu_torch import config as C
from image_segmentation_tpu_torch import run
from image_segmentation_tpu_torch.data.dataset import ArrayDataset
from image_segmentation_tpu_torch.data.loader import materialize
from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.clip_unet import ClipUNet, ClipUNetNoSkips
from image_segmentation_tpu_torch.models.clip_vit import (
    ClipViT,
    ClipViTConfig,
    hf_vision_npz_arrays,
    load_pretrained_clip_state,
)
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.ops import geometry as port_geometry
from image_segmentation_tpu_torch.train import checkpoint as ckpt
from image_segmentation_tpu_torch.train import loop
from image_segmentation_tpu_torch.train.state import TrainState, freeze_

torch.set_num_threads(1)

SIDE = 64
TINY = ["--smoke-vit", "--synthetic", "16", "--target-size", str(SIDE), "--device", "cpu"]
SMOKE_VIT = dict(image_size=SIDE, patch_size=16, hidden_size=64, num_layers=4, num_heads=4,
                 mlp_dim=128)


def _write_npz(path):
    """A seeded random smoke-size ViT in the CLIP .npz layout."""
    vit = ClipViT(ClipViTConfig(**SMOKE_VIT))
    vit.init_weights(torch.Generator().manual_seed(42))
    np.savez(path, **hf_vision_npz_arrays(vit.state_dict()))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of each path; the prompt run's model as it stood when fit
    began (after the graft)."""
    save = tmp_path_factory.mktemp("clip_runs")
    npz = _write_npz(str(save / "clip.npz"))
    out = {}
    for name, argv in (
            ("clipunet", ["--config", "clipunet", "--epochs", "2", "--clip-weights", npz]),
            ("cached", ["--config", "clipunet", "--epochs", "2", "--clip-weights", npz,
                        "--cache-features"]),
            ("noskips", ["--config", "clipunet_noskips", "--epochs", "1", "--cache-features"])):
        out[name] = run.main(argv + TINY + ["--save-dir", str(save / name)])
    real_fit, grafted = loop.fit, {}

    def capture(state, *a, **k):
        grafted.update({k_: v.clone() for k_, v in state.model.state_dict().items()})
        return real_fit(state, *a, **k)

    loop.fit = capture
    try:
        out["prompt"] = run.main(["--config", "prompt", "--epochs", "1", "--clipunet-checkpoint",
                                  str(save / "clipunet" / "MO_clipunet")] + TINY
                                 + ["--save-dir", str(save / "prompt")])
    finally:
        loop.fit = real_fit
    return save, npz, out, grafted


def test_clipunet_fits_writes_its_checkpoints_and_resumes(runs, tmp_path):
    save, _, out, _ = runs
    res = out["clipunet"]
    for d in ("clipunet", "clipunet_last", "MO_clipunet"):
        assert os.path.isdir(save / "clipunet" / d), d
    assert len(res.history["train_loss"]) == 2 and np.all(np.isfinite(res.history["train_loss"]))
    assert res.state.step == 2  # 16 images, micro 8 x accum 2: one step an epoch
    shutil.copytree(save / "clipunet", tmp_path / "r")
    resumed = run.main(["--config", "clipunet", "--epochs", "3", "--resume"] + TINY
                       + ["--save-dir", str(tmp_path / "r")])
    assert resumed.history["train_loss"][:2] == res.history["train_loss"]
    assert len(resumed.history["train_loss"]) == 3 and resumed.state.step == 3


def test_clip_weights_go_into_the_vit_and_stay(runs):
    """--clip-weights loads the .npz into `vision_model`; frozen out of
    AdamW, it is still those weights after training, in the model and in
    its MO_."""
    save, npz, out, _ = runs
    want = load_pretrained_clip_state(npz)
    model = out["clipunet"].state.model
    mo = ckpt.load_model_state(str(save / "clipunet" / "MO_clipunet"))
    for k, v in want.items():
        assert torch.equal(model.vision_model.state_dict()[k], v), k
        assert torch.equal(mo[f"vision_model.{k}"], v), k


def test_cache_features_gives_the_in_line_trajectory_bit_for_bit(runs):
    """The cached-feature run (decoder-only steps on features encoded once)
    and the in-line frozen run train the same: every history entry and
    every entry of the final ClipUNet state are equal."""
    _, _, out, _ = runs
    inline, cached = out["clipunet"], out["cached"]
    for k in ("train_loss", "val_loss", "val_dice", "val_iou", "val_acc"):
        assert cached.history[k] == inline.history[k], k
    decoder = cached.state.model  # the decoder-only view, trained on the features
    assert not any(k.startswith("vision_model.") for k in decoder.state_dict())
    want = inline.state.model.state_dict()
    got = ckpt.load_model_state(os.path.join(runs[0], "cached", "clipunet_last"))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cached_run_checkpoints_hold_the_whole_clipunet_unlike_jax(runs, tmp_path):
    """The port's cached-feature run writes the whole ClipUNet (the state
    `fit` evaluates): `--evaluate` reads its MO_ back and reproduces the
    best epoch, and `--resume --cache-features` continues it. JAX's fit
    saves the decoder-only state instead: its MO_ holds no encoder, JAX's
    own `--evaluate` cannot load it into a ClipUNet, and JAX's graft of it
    into a prompt model (`--clipunet-checkpoint`) leaves the clip branch's
    ViT as it was."""
    save, npz, out, _ = runs
    mo = str(save / "cached" / "MO_clipunet")  # read without --clip-weights
    assert any(k.startswith("vision_model.") for k in ckpt.load_model_state(mo))
    res = run.main(["--config", "clipunet", "--evaluate", mo, "--split", "Val"] + TINY)
    assert res["iou"] == pytest.approx(out["cached"].best["miou"], abs=1e-12)
    shutil.copytree(save / "cached", tmp_path / "r")
    resumed = run.main(["--config", "clipunet", "--epochs", "3", "--resume", "--cache-features",
                        "--clip-weights", npz] + TINY + ["--save-dir", str(tmp_path / "r")])
    assert len(resumed.history["train_loss"]) == 3 and resumed.state.step == 3

    jax_run.main(["--config", "clipunet", "--smoke-vit", "--synthetic", "16", "--epochs", "1",
                  "--target-size", str(SIDE), "--cache-features", "--save-dir",
                  str(tmp_path / "jax")])
    jmo = str(tmp_path / "jax" / "MO_clipunet")
    assert sorted(jax_ckpt.load_variables_only(jmo)["params"]) == [
        "dec_0", "dec_1", "dec_2", "dec_3", "head", "init_conv"]
    with pytest.raises(Exception, match="encoder"):
        jax_run.main(["--config", "clipunet", "--smoke-vit", "--synthetic", "16",
                      "--target-size", str(SIDE), "--evaluate", jmo, "--split", "Val"])
    prompt = JaxPromptModel(vit=JaxViTConfig(**SMOKE_VIT), skip_indices=(1, 2, 3, 4),
                            decoder_channels=(64, 32, 16, 8, 8), unet_base=8)
    before = prompt.init(jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)),
                         jnp.zeros((1, SIDE, SIDE, 1)))
    after = jax_ckpt.load_subtree_variables(jmo, before, src_prefix="", dst_prefix="clip")
    for a, b in zip(jax.tree_util.tree_leaves(after["params"]["clip"]["encoder"]),
                    jax.tree_util.tree_leaves(before["params"]["clip"]["encoder"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_noskips_fits_and_ignores_cache_features_with_a_note(runs, capsys):
    _, _, out, _ = runs
    res = out["noskips"]
    assert np.isfinite(res.history["train_loss"][0])
    assert isinstance(res.state.model, ClipUNetNoSkips)
    run.main(["--config", "clipunet_noskips", "--epochs", "1", "--cache-features"] + TINY
             + ["--save-dir", str(runs[0] / "noskips_again")])
    assert "--cache-features ignored" in capsys.readouterr().out


def test_prompt_fits_on_the_grafted_clip_branch(runs):
    """prompt --clipunet-checkpoint: when fit begins, every entry of the
    clip branch (parameters and BN statistics) is the ClipUNet
    checkpoint's; after training its ViT still is, and the run trained on
    prompt triplets to a finite loss."""
    save, _, out, grafted = runs
    src = ckpt.load_model_state(str(save / "clipunet" / "MO_clipunet"))
    for k, v in src.items():
        assert torch.equal(grafted[f"clip.{k}"], v), k
    after = out["prompt"].state.model.state_dict()
    for k, v in src.items():
        if k.startswith("vision_model."):
            assert torch.equal(after[f"clip.{k}"], v), k
    assert np.isfinite(out["prompt"].history["train_loss"][0])
    assert out["prompt"].state.step == 1  # 32 triplets: one step of micro 8 x accum 4


@pytest.mark.parametrize("name,config", [("clipunet", "clipunet"), ("cached", "clipunet"),
                                         ("noskips", "clipunet_noskips"), ("prompt", "prompt")])
def test_evaluate_reads_each_configs_mo(runs, name, config):
    """`--evaluate MO_ --split Val` reproduces the best epoch's val mIoU and
    loss: the same synthetic set (prompt triplets for the prompt config),
    weights and protocol."""
    save, _, out, _ = runs
    res = run.main(["--config", config, "--evaluate", str(save / name / f"MO_{config}"),
                    "--split", "Val"] + TINY)
    assert res["iou"] == pytest.approx(out[name].best["miou"], abs=1e-12)
    assert res["loss"] == pytest.approx(out[name].best["loss"], rel=1e-6)


def test_without_a_card_the_default_device_refuses(runs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        run.main(["--config", "clipunet", "--smoke-vit", "--synthetic", "16"])


@pytest.fixture
def jax_numpy_path(monkeypatch):
    """Both packages on their numpy resamplers: their materialised inputs
    are then bit-equal (tests/test_torch_loader.py)."""
    monkeypatch.setattr(jax_geometry, "_native", lambda: None)
    monkeypatch.setattr(port_geometry, "_native", lambda: None)


def test_three_step_clipunet_fit_matches_jax_fit(jax_numpy_path, tmp_path):
    """Three epochs of one step (16 images, micro 8 x accum 2) of the
    frozen clipunet recipe (FullWeight Dice + CE, AdamW 1e-3 / 0.01, the ViT
    masked out) in both packages from one JAX init, on the same data and
    shuffle seed. As tests/test_torch_fit.py states its bounds: step 1's
    loss within 1e-4 relative (the same sums in another order), steps 2 and
    3 within 2e-3 (Adam's ±lr steps on the sign of tiny gradients drift;
    both at most 5e-5 seen), the val loss within 2e-3 and the val macro
    metrics within 5e-3 absolute (argmax near-ties among 4 small images)."""
    items = lambda n, seed: [(img[::4, ::4].copy(), np.where(lab[::4, ::4] == 255, 3,  # noqa
                                                             lab[::4, ::4]))
                             for img, lab in run._synthetic_items(n, seed)]
    train, val = items(16, 0), items(4, 1)
    cfg = JC.CLIPUNET
    model = JaxClipUNet(vit=JaxViTConfig(**SMOKE_VIT), skip_indices=(1, 2, 3, 4),
                        decoder_channels=(64, 32, 16, 8, 8))
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)))
    mask = subtree_mask(variables["params"], ("encoder",))
    jstate = create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)),
                                JC.build_optimizer(cfg, trainable_mask=mask))
    init = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, jstate.params),
                               "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                     jstate.batch_stats)})
    kw = dict(epochs=3, batch_size=16, accum_steps=2, name="clipunet", seed=3, verbose=False,
              eval_batch_size=8)
    want = jax_loop.fit(jstate, jax_materialize(JaxArrayDataset(train), SIDE),
                        jax_materialize(JaxArrayDataset(val), SIDE, keep_orig_labels=True),
                        loss_fn=JaxDiceCE(class_weights=cfg.class_weights, smooth_dice=1.0),
                        save_dir=str(tmp_path / "jax"), **kw).history

    port = ClipUNet(vit=ClipViTConfig(**SMOKE_VIT), skip_indices=(1, 2, 3, 4),
                    decoder_channels=(64, 32, 16, 8, 8))
    port.load_state_dict(init, strict=True)
    port = port.to(memory_format=torch.channels_last)
    freeze_(port, ("vision_model",))
    st = TrainState(port, *C.build_optimizer(C.CLIPUNET, port, frozen_prefixes=("vision_model",)))
    got = loop.fit(st, materialize(ArrayDataset(train), SIDE),
                   materialize(ArrayDataset(val), SIDE, keep_orig_labels=True),
                   loss_fn=C.build_loss(C.CLIPUNET), save_dir=str(tmp_path / "port"),
                   **kw).history
    np.testing.assert_allclose(got["train_loss"][0], want["train_loss"][0], rtol=1e-4)
    np.testing.assert_allclose(got["train_loss"][1:], want["train_loss"][1:], rtol=2e-3)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], atol=2e-3)
    for k in ("val_dice", "val_iou", "val_acc"):
        np.testing.assert_allclose(got[k], want[k], atol=5e-3, err_msg=k)
