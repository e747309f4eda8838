"""The port's run CLI (`python -m image_segmentation_tpu_torch.run`): the
`unet_noaug` training path end to end on the CPU, `--evaluate` on its own
checkpoints, and what it refuses."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from image_segmentation_tpu_torch import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--config", "unet_noaug", "--synthetic", "8", "--epochs", "2", "--target-size", "32",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    save = tmp_path_factory.mktemp("run")
    torch.manual_seed(0)
    result = run.main(TINY + ["--save-dir", str(save)])
    return save, result


def test_cli_trains_unet_noaug_on_the_cpu(trained):
    save, result = trained
    for d in ("unet_noaug", "unet_noaug_last", "MO_unet_noaug"):
        assert os.path.isdir(save / d), d
    with open(save / "metrics" / "unet_noaug.json") as f:
        history = json.load(f)
    assert len(history["train_loss"]) == 2 and len(history["val_iou"]) == 2
    assert all(v == v for v in history["train_loss"])  # finite, not nan
    assert result.state.step == 2  # 8 images, micro 8, one step per epoch
    assert max(history["val_iou"]) == pytest.approx(result.best["miou"])


@pytest.mark.parametrize("ckpt", ["unet_noaug", "MO_unet_noaug"])
def test_evaluate_reads_the_ports_checkpoints(trained, ckpt):
    """`--evaluate` on the 'Val' split reproduces the best epoch's val
    metrics: the same synthetic set, weights and protocol."""
    save, result = trained
    res = run.main(TINY + ["--save-dir", str(save), "--evaluate", str(save / ckpt),
                           "--split", "Val"])
    assert res["iou"] == pytest.approx(result.best["miou"], abs=1e-12)
    assert res["loss"] == pytest.approx(result.best["loss"], rel=1e-6)


def test_resume_continues_the_history(trained, tmp_path):
    save, _ = trained
    shutil.copytree(save, tmp_path / "r")
    res = run.main(TINY + ["--epochs", "3", "--save-dir", str(tmp_path / "r"), "--resume"])
    assert len(res.history["train_loss"]) == 3 and res.state.step == 3


@pytest.mark.parametrize("argv,message", [
    (["--config", "nope", "--synthetic", "8", "--device", "cpu"], "unknown config"),
    (TINY + ["--platform", "tpu"], "--device"),
    (["--config", "unet_noaug", "--device", "cpu"], "--data-root or --synthetic"),
    (TINY + ["--multihost"], "--multihost"),
    (TINY + ["--init-weights", "w.safetensors"], "--init-weights"),  # not a checkpoint
    (TINY + ["--max-devices", "2"], "--max-devices"),
])
def test_refused_with_a_message(argv, message, monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)  # --multihost finds no group
    with pytest.raises(SystemExit) as e:
        run.main(argv)
    assert isinstance(e.value.code, str) and message in e.value.code


def test_cuda_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "image_segmentation_tpu_torch.run",
                        "--config", "unet_noaug", "--synthetic", "8"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "no CUDA device" in p.stderr


def test_training_modules_import_no_jax():
    code = ("import sys, image_segmentation_tpu_torch.run, image_segmentation_tpu_torch.config, "
            "image_segmentation_tpu_torch.train.loop, image_segmentation_tpu_torch.train.steps, "
            "image_segmentation_tpu_torch.train.multihost_loop, "
            "image_segmentation_tpu_torch.parallel.multihost, "
            "image_segmentation_tpu_torch.utils.profiling, image_segmentation_tpu_torch.utils.tb, "
            "image_segmentation_tpu_torch.utils.viz; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'image_segmentation_tpu.')) or m == 'image_segmentation_tpu']; "
            "assert not bad, bad")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
