"""The port's tooling (utils/profiling.py, utils/tb.py, utils/viz.py) and
the CLI flags that reach it: `--profile-dir`, `--nan-checks`,
`--tensorboard`, and `fit`'s `metrics_logger` under JAX's scalar names
(train/loop.py:925-934 there). TensorBoard event files are read back with
TensorBoard's own reader, as tests/test_tb_logging.py reads JAX's."""
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch import run
from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
from image_segmentation_tpu_torch.train.steps import train_step
from image_segmentation_tpu_torch.utils import profiling, tb, viz

torch.set_num_threads(1)

TINY = ["--config", "unet_noaug", "--synthetic", "8", "--epochs", "2", "--target-size", "32",
        "--batch-size", "4", "--device", "cpu"]
JAX_SCALARS = ("train/loss", "val/loss", "val/dice", "val/miou", "val/acc", "time/epoch_s",
               "val/per_class_iou_0")


def _read_scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(logdir)
    acc.Reload()
    return {tag: [(s.step, s.value) for s in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}


@pytest.fixture(autouse=True)
def nan_checks_off():
    yield
    profiling.enable_nan_checks(False)


def test_cli_writes_tensorboard_scalars_trace_and_enables_nan_checks(tmp_path):
    res = run.main(TINY + ["--save-dir", str(tmp_path / "runs"), "--tensorboard",
                           str(tmp_path / "tb"), "--profile-dir", str(tmp_path / "prof"),
                           "--nan-checks"])
    assert profiling.NAN_CHECKS
    scalars = _read_scalars(str(tmp_path / "tb" / "unet_noaug"))
    for tag in JAX_SCALARS:
        assert [s for s, _ in scalars[tag]] == [1, 2], tag
    np.testing.assert_allclose([v for _, v in scalars["train/loss"]],
                               res.history["train_loss"], rtol=1e-6)
    traces = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("conv" in n for n in names)  # the fit's ops were recorded


def test_recon_cli_logs_jax_mse_scalars(tmp_path):
    run.main(["--config", "recon_ae", "--synthetic", "8", "--epochs", "1", "--target-size", "32",
              "--batch-size", "4", "--device", "cpu", "--save-dir", str(tmp_path / "runs"),
              "--tensorboard", str(tmp_path / "tb")])
    scalars = _read_scalars(str(tmp_path / "tb" / "recon_ae"))
    assert {"train/mse", "val/mse", "time/epoch_s"} <= set(scalars)


def test_trace_context_none_is_a_no_op(tmp_path):
    with profiling.trace_context(None):
        torch.ones(2).sum()
    assert os.listdir(tmp_path) == []


def _state():
    model = UNet(base=4).to(memory_format=torch.channels_last)
    return TrainState(model, *make_adamw(model.parameters()))


def _batch(nan_input=False):
    g = torch.Generator().manual_seed(0)
    x = torch.rand(4, 32, 32, 3, generator=g)
    if nan_input:
        x[1, 3, 4, 0] = float("nan")
    return x, torch.randint(0, 4, (4, 32, 32), generator=g)


def test_nan_checks_raise_at_the_first_non_finite_loss_naming_the_step():
    st = _state()
    profiling.enable_nan_checks()
    train_step(st, DiceCELoss(), *_batch(), 2)
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    with pytest.raises(FloatingPointError, match=r"non-finite loss \(micro-batch 0\) at train "
                                                 r"step 1"):
        train_step(st, DiceCELoss(), *_batch(nan_input=True), 2)
    # the optimizer did not move
    for k, v in st.model.state_dict().items():
        if "running" not in k:
            assert torch.equal(v, before[k]), k
    profiling.enable_nan_checks(False)
    assert not np.isfinite(float(train_step(_state(), DiceCELoss(), *_batch(True), 2)))


def test_nan_checks_raise_at_a_non_finite_gradient():
    """A finite loss whose gradient is not: d sqrt(u)/du at u = 0."""
    profiling.enable_nan_checks()
    loss = lambda out, t: (out.float() * 0).sum().sqrt()  # noqa: E731
    with pytest.raises(FloatingPointError, match="non-finite gradient at train step 0"):
        train_step(_state(), loss, *_batch(), 1)


def test_step_timer_skips_warmup_and_summarises():
    timer = profiling.StepTimer(warmup_steps=1, device="cpu")
    for _ in range(3):
        with timer.step():
            torch.ones(8).sum()
    assert len(timer.times) == 2 and timer.mean_s > 0
    assert timer.summary(batch_size=8).startswith("2 steps, mean")
    assert profiling.StepTimer().images_per_sec(8) != profiling.StepTimer().images_per_sec(8)


def test_logger_fans_out_arrays(tmp_path):
    lg = tb.TensorBoardLogger(str(tmp_path))
    lg.log(1, {"a": 0.5, "b": np.array([1.0, 2.0])})
    lg.close()
    scalars = _read_scalars(str(tmp_path))
    assert scalars["a"] == [(1, 0.5)] and scalars["b_0"] == [(1, 1.0)]
    assert scalars["b_1"] == [(1, 2.0)]
    assert tb.maybe_logger(None) is None


def test_tensorboard_without_tensorboardx_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError, match="needs the tensorboardX package"):
        tb.TensorBoardLogger(str(tmp_path))
    with pytest.raises(ImportError, match="drop --tensorboard"):
        run.main(TINY + ["--save-dir", str(tmp_path / "r"), "--tensorboard", str(tmp_path)])
    assert tb.maybe_logger("") is None  # nothing asked, nothing needed


def test_viz_writes_pngs_headless(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    mask = rng.integers(0, 4, (32, 40))
    paths = [viz.display_img_label(img, mask, save_path=str(tmp_path / "a.png")),
             viz.plot_mask_with_colors(mask, save_path=str(tmp_path / "b.png")),
             viz.plot_prediction_triptych(img, mask, mask, save_path=str(tmp_path / "c.png")),
             viz.plot_training_curves({"train_loss": [1.0, 0.5], "val_loss": [1.1, 0.6],
                                       "val_iou": [0.2, 0.3]},
                                      save_path=str(tmp_path / "d.png"))]
    import matplotlib

    assert matplotlib.get_backend().lower() == "agg"
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
