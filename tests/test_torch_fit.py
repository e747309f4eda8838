"""The port's `fit` held against the JAX package's, and its checkpoints.

- Two epochs of `fit` in both packages from one JAX init (carried over by
  `models.convert.from_jax_variables`), the same materialised data and
  the same shuffle seed: per-epoch train losses and val metrics.
- One epoch, then a resume for one more, equals two epochs bit for bit
  on the CPU (the port replays the shuffle generator to the resumed
  epoch; JAX reseeds with seed + start_epoch, loop.py:853, so a resumed
  JAX run draws other batches than an uninterrupted one).
- The weights-only `MO_` artifact loads into the serving InferenceEngine
  and serves a mask.
- Early stop writes `stopped_early` into the saved metrics file. This is
  what the JAX loop means to do; it sets the key after saving the
  history (loop.py:961), so its file never holds it.
- A SIGTERM stops the run after the epoch, with its checkpoint written;
  a write-behind save holds the state of the moment it was asked for.
"""
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from image_segmentation_tpu.data.loader import materialize as jax_materialize
from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
from image_segmentation_tpu.models import UNet as JaxUNet
from image_segmentation_tpu.ops import geometry as jax_geometry
from image_segmentation_tpu.train import create_train_state
from image_segmentation_tpu.train import loop as jax_loop
from image_segmentation_tpu.train.state import make_adamw as jax_adamw
from image_segmentation_tpu_torch import config as C
from image_segmentation_tpu_torch.data.dataset import ArrayDataset
from image_segmentation_tpu_torch.data.labels import target_remap
from image_segmentation_tpu_torch.data.loader import materialize
from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.ops import geometry as port_geometry
from image_segmentation_tpu_torch.run import _synthetic_items
from image_segmentation_tpu_torch.serve.engine import InferenceEngine
from image_segmentation_tpu_torch.train import checkpoint as ckpt
from image_segmentation_tpu_torch.train.loop import fit
from image_segmentation_tpu_torch.train.state import TrainState, make_adamw

torch.set_num_threads(1)

SIDE, BASE, LR, WD = 32, 8, 1e-3, 0.01
# the unet_noaug recipe: FullWeight, no ignore index, train smooth 1
LOSS_KW = dict(class_weights=C.FULL_WEIGHTS, smooth_dice=1.0)
FIT_KW = dict(epochs=2, batch_size=8, accum_steps=2, name="unet_noaug", seed=3,
              verbose=False)


@pytest.fixture(autouse=True)
def jax_numpy_path(monkeypatch):
    """Both packages on their numpy resamplers: their materialised inputs
    are then bit-equal (tests/test_torch_loader.py)."""
    monkeypatch.setattr(jax_geometry, "_native", lambda: None)
    monkeypatch.setattr(port_geometry, "_native", lambda: None)


def _items(n, seed):
    # the synthetic task of run.py at small sizes (the same boxes and
    # boundary column), its 255 boundary remapped to class 3
    return [(img[::4, ::4].copy(), target_remap(lab[::4, ::4]))
            for img, lab in _synthetic_items(n, seed)]


@pytest.fixture(scope="module")
def data():
    train, val = _items(16, 0), _items(6, 1)
    return train, val


def _port_data(data):
    train, val = data
    return (materialize(ArrayDataset(train), SIDE),
            materialize(ArrayDataset(val), SIDE, keep_orig_labels=True))


def _jax_state():
    """A fresh JAX train state from one seed (JAX's fit donates it)."""
    model = JaxUNet(num_classes=4, base=BASE, dtype=jnp.float32)
    return create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)),
                              jax_adamw(learning_rate=LR, weight_decay=WD))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX init's variables as the port's state_dict."""
    st = _jax_state()
    return from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, st.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, st.batch_stats)})


def _port_state(init) -> TrainState:
    model = UNet(base=BASE)
    model.load_state_dict(init)
    model = model.to(memory_format=torch.channels_last)
    opt, sched = make_adamw(model.parameters(), learning_rate=LR, weight_decay=WD)
    return TrainState(model, opt, sched)


def test_two_epochs_match_jax_fit(data, jax_init, tmp_path):
    train, val = data
    jtrain = jax_materialize(JaxArrayDataset(train), SIDE)
    jval = jax_materialize(JaxArrayDataset(val), SIDE, keep_orig_labels=True)
    want = jax_loop.fit(_jax_state(), jtrain, jval, loss_fn=JaxDiceCE(**LOSS_KW),
                        save_dir=str(tmp_path / "jax"), **FIT_KW).history
    ptrain, pval = _port_data(data)
    got = fit(_port_state(jax_init), ptrain, pval, loss_fn=DiceCELoss(**LOSS_KW),
              save_dir=str(tmp_path / "port"), **FIT_KW).history
    # epoch 1 is the mean of steps 1 and 2, the first identical up to f32
    # sums, the second one AdamW update later: 1e-4 relative. Epoch 2, steps
    # 3 and 4, carries the drift of Adam's ±lr steps on the sign of tiny
    # gradients (tests/test_torch_train_step.py; test_trajectory_parity
    # allows 5e-4 at step 3): 2e-3 relative, observed 7.7e-4
    np.testing.assert_allclose(got["train_loss"][0], want["train_loss"][0], rtol=1e-4)
    np.testing.assert_allclose(got["train_loss"][1], want["train_loss"][1], rtol=2e-3)
    # val metrics of the updated weights through both device protocols. The
    # weights differ by that drift, which moves logits by ~1e-2 and flips
    # argmax near-ties among the 6 small val images' ~1.3e4 pixels: macro
    # metrics 5e-3 (observed ≤ 1.6e-3), per-class IoU 1e-2 (observed
    # ≤ 4.4e-3), the val loss 2e-3 (observed ≤ 4.5e-4)
    for k in ("val_dice", "val_iou", "val_acc"):
        np.testing.assert_allclose(got[k], want[k], atol=5e-3, err_msg=k)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], atol=2e-3)
    np.testing.assert_allclose(np.asarray(got["val_per_class_iou"], float),
                               np.asarray(want["val_per_class_iou"], float), atol=1e-2)


def _same_state(a: TrainState, b: TrainState):
    for (name, ta), tb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(ta, tb), name
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for f in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k][f], sb[k][f]), (k, f)
    assert a.step == b.step


def test_resume_equals_an_uninterrupted_run_bit_for_bit(data, jax_init, tmp_path):
    ptrain, pval = _port_data(data)
    full = fit(_port_state(jax_init), ptrain, pval, loss_fn=DiceCELoss(**LOSS_KW),
               save_dir=str(tmp_path / "full"), **FIT_KW)
    kw = dict(FIT_KW, epochs=1)
    fit(_port_state(jax_init), ptrain, pval, loss_fn=DiceCELoss(**LOSS_KW),
        save_dir=str(tmp_path / "split"), **kw)
    # a fresh state (the weights of the JAX init again), restored from disk
    resumed = fit(_port_state(jax_init), ptrain, pval, loss_fn=DiceCELoss(**LOSS_KW),
                  save_dir=str(tmp_path / "split"), resume=True, **FIT_KW)
    _same_state(resumed.state, full.state)
    for k in ("train_loss", "val_loss", "val_dice", "val_iou", "val_acc"):
        assert resumed.history[k] == full.history[k], k
    assert resumed.best == full.best
    with open(tmp_path / "split" / "metrics" / "unet_noaug.json") as f:
        assert len(json.load(f)["train_loss"]) == 2
    for d in ("unet_noaug", "unet_noaug_last", "MO_unet_noaug"):
        assert os.path.isdir(tmp_path / "split" / d), d


def test_weights_only_artifact_serves_a_mask(data, jax_init, tmp_path):
    ptrain, pval = _port_data(data)
    res = fit(_port_state(jax_init), ptrain, pval, loss_fn=DiceCELoss(**LOSS_KW),
              save_dir=str(tmp_path), **dict(FIT_KW, epochs=1))
    cfg = C.UNET_NOAUG
    model = C.build_model(cfg, "cpu", torch.Generator().manual_seed(1), base=BASE)
    model.load_state_dict(ckpt.load_model_state(str(tmp_path / "MO_unet_noaug")))
    for (name, a), b in zip(model.state_dict().items(), res.state.model.state_dict().values()):
        assert torch.equal(a, b), name
    eng = InferenceEngine(device="cpu")
    eng.register("unet", model, SIDE)
    img = data[1][0][0]
    out = eng.segment(img, "unet")
    assert out["mask"].shape == img.shape[:2] and out["mask"].max() <= 3
    # the served scores are the trained model's eval forward
    res.state.model.eval()
    assert out["mask"].dtype.kind in "iu"


def test_early_stop_writes_stopped_early(data, jax_init, tmp_path):
    """The val metrics come from a frozen copy of the initial weights
    (`eval_state_fn`), so no epoch after the first improves: patience 1
    stops after epoch 2, and the saved history says so."""
    ptrain, pval = _port_data(data)
    frozen = _port_state(jax_init)
    res = fit(_port_state(jax_init), ptrain, pval, loss_fn=DiceCELoss(**LOSS_KW),
              save_dir=str(tmp_path), early_stop_patience=1, eval_state_fn=lambda s: frozen,
              **dict(FIT_KW, epochs=5))
    assert res.history["stopped_early"] == [2]
    assert len(res.history["train_loss"]) == 2
    with open(tmp_path / "metrics" / "unet_noaug.json") as f:
        assert json.load(f)["stopped_early"] == [2]
    with open(tmp_path / "unet_noaug_last" / ckpt.META_FILE) as f:
        meta = json.load(f)
    assert meta["epoch"] == 1 and meta["history"]["stopped_early"] == [2]


def test_sigterm_stops_after_the_epoch_with_a_checkpoint(data, jax_init, tmp_path):
    ptrain, pval = _port_data(data)
    sent = []

    def eval_state(s):
        if not sent:
            sent.append(1)
            os.kill(os.getpid(), signal.SIGTERM)
        return s

    before = signal.getsignal(signal.SIGTERM)
    res = fit(_port_state(jax_init), ptrain, pval, loss_fn=DiceCELoss(**LOSS_KW),
              save_dir=str(tmp_path), eval_state_fn=eval_state, **dict(FIT_KW, epochs=3))
    assert len(res.history["train_loss"]) == 1
    assert signal.getsignal(signal.SIGTERM) == before
    with open(tmp_path / "unet_noaug_last" / ckpt.META_FILE) as f:
        assert json.load(f)["epoch"] == 0


def test_write_behind_save_holds_the_state_it_was_asked_for(data, jax_init, tmp_path):
    """The snapshot is taken when the save is submitted: a parameter
    update made right after (the next optimizer step, in place) does not
    reach the file."""
    st = _port_state(jax_init)
    want = {k: v.clone() for k, v in st.model.state_dict().items()}
    writer = ckpt.CheckpointWriter()
    ckpt.save_checkpoint_async(writer, str(tmp_path / "a"), st, epoch=4, best={"miou": 0.5},
                               params_only_path=str(tmp_path / "MO_a"), slot="best")
    with torch.no_grad():
        for p in st.model.parameters():
            p.add_(1.0)
    writer.wait()
    for path in ("a", "MO_a"):
        got = ckpt.load_model_state(str(tmp_path / path))
        for k in want:
            assert torch.equal(got[k], want[k]), (path, k)
    fresh = _port_state(jax_init)
    _, meta = ckpt.restore_checkpoint(str(tmp_path / "a"), fresh)
    assert meta["epoch"] == 4 and meta["best"] == {"miou": 0.5}
