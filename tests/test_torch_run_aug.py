"""The run CLI's new configs end to end on the CPU at 64 px: `unet_aug`
with online augmentation and with `--offline-aug`, `recon_ae` and then
`autoencoder --pretrained-encoder` on its checkpoint, `--evaluate` of
both, `--init-weights`, and what stays refused."""
import os

import pytest
import torch

from image_segmentation_tpu_torch import run
from image_segmentation_tpu_torch.data import augment as offline
from image_segmentation_tpu_torch.ops import augment as A
from image_segmentation_tpu_torch.train import checkpoint as ckpt

BASE = ["--synthetic", "8", "--target-size", "64", "--device", "cpu"]


def _argv(config, save, *extra):
    return ["--config", config, "--save-dir", str(save)] + BASE + list(extra)


def test_unet_aug_online_augments_every_step(tmp_path, monkeypatch):
    calls = []
    real = A.random_augment_batch

    def spy(images, labels, generator):
        calls.append(images.shape[0])
        return real(images, labels, generator)

    monkeypatch.setattr(A, "random_augment_batch", spy)
    res = run.main(_argv("unet_aug", tmp_path, "--epochs", "2"))
    assert calls == [8, 8] and res.state.step == 2  # one 8-row step an epoch
    assert len(res.history["train_loss"]) == 2
    for d in ("unet_aug", "unet_aug_last", "MO_unet_aug"):
        assert os.path.isdir(tmp_path / d), d
    # --augment off trains the same config without it
    calls.clear()
    run.main(_argv("unet_aug", tmp_path / "off", "--epochs", "1", "--augment", "off"))
    assert calls == []


def test_unet_aug_offline_expands_the_train_set(tmp_path, monkeypatch, capsys):
    seen = []
    real = offline.generate_augmented_dataset

    def spy(ds, **kw):
        seen.append((len(ds), kw))
        # built before the label remap: the boundary sentinel is still 255
        assert any((lab == 255).any() for _, lab in ds.items)
        return real(ds, **kw)

    monkeypatch.setattr(offline, "generate_augmented_dataset", spy)
    monkeypatch.setattr(A, "random_augment_batch", None)  # no online augmentation
    res = run.main(_argv("unet_aug", tmp_path, "--epochs", "1", "--offline-aug"))
    assert seen == [(8, {"seed": 0, "size": 64})]
    n = int(capsys.readouterr().out.split("[run] materialising ")[-1].split()[0])
    # the 8 bases and their augmented copies; steps of micro 8 x accum
    assert n > 8 and res.state.step == n // (8 * min(8, n // 8))
    assert res.history["train_loss"][0] == res.history["train_loss"][0]  # not nan


@pytest.fixture(scope="module")
def two_stage(tmp_path_factory):
    save = tmp_path_factory.mktemp("ae")
    recon = run.main(_argv("recon_ae", save, "--epochs", "2"))
    seg = run.main(_argv("autoencoder", save, "--epochs", "2",
                         "--pretrained-encoder", str(save / "recon_ae")))
    return save, recon, seg


def test_recon_then_autoencoder_with_the_pretrained_encoder(two_stage):
    save, recon, seg = two_stage
    assert len(recon.history["train_loss"]) == 2 and recon.best["loss"] > 0
    assert sorted(os.listdir(save / "metrics")) == ["autoencoder.json", "recon_ae.json"]
    assert not os.path.exists(save / "MO_recon_ae") and os.path.isdir(save / "MO_autoencoder")
    src = ckpt.load_model_state(str(save / "recon_ae"))
    sd = seg.state.model.state_dict()
    enc = [k for k in src if k.startswith("encoder.")]
    assert enc and all(k in sd for k in enc)
    for k in enc:  # frozen: parameters as transferred; BN statistics moved
        assert torch.equal(sd[k], src[k]) != ("running" in k), k
    assert all(not p.requires_grad for n, p in seg.state.model.named_parameters()
               if n.startswith("encoder."))
    opt_params = {id(p) for g in seg.state.optimizer.param_groups for p in g["params"]}
    assert all(id(p) not in opt_params for n, p in seg.state.model.named_parameters()
               if n.startswith("encoder."))


def test_evaluate_both_stages(two_stage, capsys):
    save, recon, seg = two_stage
    res = run.main(_argv("recon_ae", save, "--evaluate", str(save / "recon_ae"),
                         "--split", "Val"))
    assert res["loss"] == pytest.approx(recon.best["loss"], rel=1e-6)
    assert "Val eval: mse=" in capsys.readouterr().out
    res = run.main(_argv("autoencoder", save, "--evaluate", str(save / "MO_autoencoder"),
                         "--split", "Val"))
    assert res["iou"] == pytest.approx(seg.best["miou"], abs=1e-12)


def test_init_weights_starts_from_the_checkpoint(two_stage, tmp_path):
    save, _, seg = two_stage
    res = run.main(_argv("autoencoder", tmp_path, "--epochs", "0",
                         "--init-weights", str(save / "MO_autoencoder")))
    want = ckpt.load_model_state(str(save / "MO_autoencoder"))
    for k, v in res.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("argv,message", [
    (["--config", "clipunet", "--clip-weights", "nowhere.npz"] + BASE,
     "--clip-weights nowhere.npz: no such file"),
    (["--config", "clipunet_noskips", "--init-weights", "nowhere"] + BASE,
     "not a checkpoint of this port"),
    (["--config", "prompt", "--clipunet-checkpoint", "nowhere"] + BASE,
     "not a checkpoint of this port"),
    (["--config", "unet_aug", "--multihost", "--evaluate", "x"] + BASE,
     "--evaluate and recon configs are single-process"),
    (["--config", "unet_aug", "--multihost", "--cache-features"] + BASE,
     "not supported with --multihost: --cache-features"),
    (["--config", "unet_aug", "--platform", "tpu"] + BASE, "--device"),
    (["--config", "clipunet_wide"] + BASE, "unknown config"),
    (["--config", "unet_aug", "--multihost", "--eval-protocol", "host"] + BASE,
     "not supported with --multihost: --eval-protocol host"),
] + [
    (["--config", "autoencoder", "--pretrained-encoder", "nowhere"] + BASE,
     "not a checkpoint of this port"),
])
def test_still_refused(argv, message):
    with pytest.raises(SystemExit) as e:
        run.main(argv)
    assert isinstance(e.value.code, str) and message in e.value.code
