"""The per-batch streaming paths of the port's trainer and device eval,
held against its resident paths and against the JAX package's streaming
paths.

- `resident_plan` as JAX's `_resident_plan('auto', ...)`
  (use_device_epoch=False read as 'stream'), and `fit` holds the set so;
  ViT features are float32 or streamed, never uint8.
- `StreamedTrainSet` gives the batches `ResidentTrainSet` gives in
  float32, for (image, label), (image, heatmap, label) and
  reconstruction sets; `stream_rows` yields each row set in order and
  stops its worker when closed early.
- A streamed `fit` (with and without online augmentation) and a streamed
  `fit_reconstruction` equal the resident runs on the CPU: the same
  shuffle, so the same losses and parameters, bit for bit.
- The streamed `fit` against JAX's streamed `fit`
  (ISTPU_TRAIN_DEVICE_CACHE_MB=0 and ISTPU_EVAL_DEVICE_CACHE_MB=0 on both
  sides) within the bounds tests/test_torch_fit.py states.
- The per-batch eval (ISTPU_EVAL_DEVICE_CACHE_MB past the val set) equals
  the resident eval, confusion for confusion and loss for loss, and its
  confusion equals JAX's per-batch eval's, over one canvas and over
  canvas-size buckets.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from image_segmentation_tpu.data.loader import materialize as jax_materialize
from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
from image_segmentation_tpu.metrics import MetricsHistory as JaxMetricsHistory
from image_segmentation_tpu.models import UNet as JaxUNet
from image_segmentation_tpu.ops import geometry as jax_geometry
from image_segmentation_tpu.train import create_train_state
from image_segmentation_tpu.train import loop as jax_loop
from image_segmentation_tpu.train.state import make_adamw as jax_adamw
from image_segmentation_tpu_torch import config as C
from image_segmentation_tpu_torch.data.dataset import ArrayDataset
from image_segmentation_tpu_torch.data.labels import target_remap
from image_segmentation_tpu_torch.data.loader import MaterializedDataset, materialize
from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.metrics import MetricsHistory
from image_segmentation_tpu_torch.models.autoencoder import ReconstructionAutoencoder
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.ops import augment as A
from image_segmentation_tpu_torch.ops import geometry as port_geometry
from image_segmentation_tpu_torch.run import _synthetic_items
from image_segmentation_tpu_torch.train import loop
from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
from image_segmentation_tpu_torch.train.steps import (
    ResidentTrainSet,
    StreamedTrainSet,
    resident_plan,
    stream_rows,
)

torch.set_num_threads(1)

SIDE, BASE, LR, WD = 32, 8, 1e-3, 0.01
TRAIN_ENV, EVAL_ENV = loop.BUDGET_ENV, loop.EVAL_BUDGET_ENV
MB = 2**20


@pytest.fixture(autouse=True)
def numpy_resamplers(monkeypatch):
    """Both packages on their numpy resamplers, so their materialised
    inputs are bit-equal (tests/test_torch_loader.py)."""
    monkeypatch.setattr(jax_geometry, "_native", lambda: None)
    monkeypatch.setattr(port_geometry, "_native", lambda: None)
    monkeypatch.delenv(TRAIN_ENV, raising=False)
    monkeypatch.delenv(EVAL_ENV, raising=False)


def _items(n, seed):
    return [(img[::4, ::4].copy(), target_remap(lab[::4, ::4]))
            for img, lab in _synthetic_items(n, seed)]


@pytest.fixture(scope="module")
def raw():
    return _items(24, 0), _items(6, 1)


def _port_data(raw):
    train, val = raw
    return (materialize(ArrayDataset(train), SIDE),
            materialize(ArrayDataset(val), SIDE, keep_orig_labels=True))


@pytest.mark.parametrize("f32,budget,want", [
    (400, 10**6, "float32"), (400, 400, "float32"), (400, 399, "uint8"), (400, 100, "uint8"),
    (400, 99, "stream"), (400, 0, "stream")])
def test_resident_plan_for_each_dtype(f32, budget, want):
    assert resident_plan(f32, budget) == want
    jax_fits, jax_quantize = jax_loop._resident_plan("auto", f32, budget)
    assert want == ("stream" if not jax_fits else "uint8" if jax_quantize else "float32")
    # features: float32 or streamed, never uint8
    assert resident_plan(f32, budget, quantizable=False) == (
        "float32" if f32 <= budget else "stream")


def test_stream_rows_in_order():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (10, 3, 2)).astype(np.float32)
    b = rng.integers(0, 9, (10, 4)).astype(np.int32)
    rows = [rng.permutation(10)[:4] for _ in range(5)]
    got = list(stream_rows((a, b), iter(rows), "cpu"))
    assert len(got) == 5
    for (x, y), idx in zip(got, rows):
        np.testing.assert_array_equal(x.numpy(), a[idx])
        np.testing.assert_array_equal(y.numpy(), b[idx])
        assert x.dtype == torch.float32 and y.dtype == torch.int32


@pytest.mark.parametrize("kind", ["seg", "heatmaps", "recon"])
def test_streamed_batches_equal_resident_float32_batches(kind):
    rng = np.random.default_rng(1)
    images = rng.uniform(0, 1, (12, 8, 8, 3)).astype(np.float32)
    heat = rng.uniform(0, 1, (12, 8, 8, 1)).astype(np.float32) if kind == "heatmaps" else None
    labels = None if kind == "recon" else rng.integers(0, 4, (12, 8, 8)).astype(np.int32)
    order = rng.permutation(12)[:9].reshape(3, 3)
    res = ResidentTrainSet(images, labels, "cpu", False, heatmaps=heat).batches(order)
    for got, want in zip(StreamedTrainSet(images, labels, "cpu", heatmaps=heat).batches(order),
                         res):
        flat = lambda b: [t for x in b for t in (x if isinstance(x, tuple) else (x,))]  # noqa
        for g, w in zip(flat(got), flat(want)):
            assert g.dtype == w.dtype and torch.equal(g, w)
        if kind == "recon":
            assert got[0] is got[1]


def _state(seed=0):
    torch.manual_seed(seed)
    model = UNet(base=4).init_weights(torch.Generator().manual_seed(seed))
    model = model.to(memory_format=torch.channels_last)
    return TrainState(model, *make_adamw(model.parameters()))


@pytest.mark.parametrize("augment", [False, True])
def test_streamed_fit_equals_resident_fit(raw, tmp_path, monkeypatch, augment):
    train, val = _port_data(raw)
    kw = dict(loss_fn=DiceCELoss(class_weights=None), epochs=2, batch_size=8, accum_steps=2,
              name="unet_noaug", verbose=False,
              augment_fn=A.random_augment_batch if augment else None)
    resident = loop.fit(_state(), train, val, save_dir=str(tmp_path / "r"), **kw)
    assert train.device_train_cache is not None
    monkeypatch.setenv(TRAIN_ENV, "0")
    streamed = loop.fit(_state(), train, val, save_dir=str(tmp_path / "s"), **kw)
    assert train.device_train_cache is None
    for k in ("train_loss", "val_loss", "val_iou", "val_dice", "val_acc"):
        assert streamed.history[k] == resident.history[k], k
    for (name, a), b in zip(streamed.state.model.state_dict().items(),
                            resident.state.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_resident_dtype_selects_the_train_set(raw, tmp_path, monkeypatch):
    """The budget selects the set's resident dtype: inside it float32;
    past it while a quarter fits, uint8; past that, none (streamed)."""
    train, val = _port_data(raw)
    kw = dict(loss_fn=DiceCELoss(class_weights=None), epochs=1, batch_size=8, name="u",
              verbose=False)
    loop.fit(_state(), train, val, save_dir=str(tmp_path / "a"), **kw)
    assert train.device_train_cache[1].images.dtype == torch.float32
    f32_mb = (train.images.nbytes + train.labels.nbytes) / MB
    monkeypatch.setenv(TRAIN_ENV, str(f32_mb / 2))
    loop.fit(_state(), train, val, save_dir=str(tmp_path / "b"), **kw)
    assert train.device_train_cache[1].quantize
    assert train.device_train_cache[1].images.dtype == torch.uint8
    monkeypatch.setenv(TRAIN_ENV, str(f32_mb / 8))
    loop.fit(_state(), train, val, save_dir=str(tmp_path / "c"), **kw)
    assert train.device_train_cache is None


def test_stream_rows_stops_its_worker_when_closed_early():
    """A consumer that stops after the first batch leaves no gather running."""
    import threading

    a = np.arange(40, dtype=np.float32).reshape(10, 4)
    gen = stream_rows((a,), ([i] for i in range(10)), "cpu")
    (x,) = next(gen)
    np.testing.assert_array_equal(x.numpy(), a[[0]])
    gen.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("stream_rows")]


def test_streamed_fit_reconstruction_equals_resident(raw, tmp_path, monkeypatch):
    train, val = _port_data(raw)
    recon = MaterializedDataset(images=train.images[:16], labels=train.labels[:16],
                                metas=train.metas)
    originals = [img for img, _ in raw[1]]

    def run(save_dir):
        model = ReconstructionAutoencoder(base=4).init_weights(
            torch.Generator().manual_seed(0))
        st = TrainState(model, make_adamw(model.parameters(), weight_decay=0.0)[0])
        return loop.fit_reconstruction(st, recon, val, originals=originals, epochs=2,
                                       batch_size=8, accum_steps=2,
                                       save_dir=str(tmp_path / save_dir), name="recon_ae",
                                       verbose=False)

    resident = run("r")
    monkeypatch.setenv(TRAIN_ENV, "0")
    streamed = run("s")
    assert recon.device_train_cache is None
    assert streamed.history["train_loss"] == resident.history["train_loss"]
    assert streamed.history["val_loss"] == resident.history["val_loss"]
    for (name, a), b in zip(streamed.state.model.state_dict().items(),
                            resident.state.model.state_dict().values()):
        assert torch.equal(a, b), name


def _jax_state():
    model = JaxUNet(num_classes=4, base=BASE, dtype=jnp.float32)
    return create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)),
                              jax_adamw(learning_rate=LR, weight_decay=WD))


def test_streamed_fit_matches_jax_streamed_fit(tmp_path, monkeypatch):
    """Both trainers stream (their budgets 0), in the setting of
    tests/test_torch_fit.py::test_two_epochs_match_jax_fit (16 train and 6
    val images, the unet_noaug loss, two epochs of micro 4 × accum 2 from
    one JAX init, shuffle seed 3), and within the bounds that test states:
    epoch 1's loss 1e-4 relative, epoch 2's 2e-3; val macro metrics 5e-3,
    per-class IoU 1e-2, the val loss 2e-3."""
    monkeypatch.setenv(TRAIN_ENV, "0")
    monkeypatch.setenv(EVAL_ENV, "0")
    raw = train, val = _items(16, 0), _items(6, 1)
    fit_kw = dict(epochs=2, batch_size=8, accum_steps=2, name="unet_noaug", seed=3,
                  verbose=False)
    loss_kw = dict(class_weights=C.FULL_WEIGHTS, smooth_dice=1.0)
    js = _jax_state()
    init = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, js.params),
                               "batch_stats": jax.tree_util.tree_map(np.asarray, js.batch_stats)})
    want = jax_loop.fit(js, jax_materialize(JaxArrayDataset(train), SIDE),
                        jax_materialize(JaxArrayDataset(val), SIDE, keep_orig_labels=True),
                        loss_fn=JaxDiceCE(**loss_kw), save_dir=str(tmp_path / "jax"),
                        **fit_kw).history
    model = UNet(base=BASE)
    model.load_state_dict(init)
    model = model.to(memory_format=torch.channels_last)
    ptrain, pval = _port_data(raw)
    got = loop.fit(TrainState(model, *make_adamw(model.parameters(), learning_rate=LR,
                                                 weight_decay=WD)),
                   ptrain, pval, loss_fn=DiceCELoss(**loss_kw), save_dir=str(tmp_path / "port"),
                   **fit_kw).history
    assert ptrain.device_train_cache is None and pval.device_eval_cache is None
    np.testing.assert_allclose(got["train_loss"][0], want["train_loss"][0], rtol=1e-4)
    np.testing.assert_allclose(got["train_loss"][1], want["train_loss"][1], rtol=2e-3)
    for k in ("val_dice", "val_iou", "val_acc"):
        np.testing.assert_allclose(got[k], want[k], atol=5e-3, err_msg=k)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], atol=2e-3)
    np.testing.assert_allclose(np.asarray(got["val_per_class_iou"], float),
                               np.asarray(want["val_per_class_iou"], float), atol=1e-2)


VAL_CFG = dict(ignore_index=3, class_weights=(0.2047, 1.0272, 1.2293, 1.5388),
               smooth_dice=1e-5)


@pytest.fixture(scope="module")
def eval_states():
    """One JAX UNet (BN statistics off 0 and 1) and the port's copy."""
    js = create_train_state(JaxUNet(num_classes=4, base=8, dtype=jnp.float32),
                            jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)), jax_adamw(1e-3))
    rng = np.random.default_rng(9)
    js = js.replace(batch_stats=jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        js.batch_stats))
    port = UNet(base=8)
    port.load_state_dict(from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, js.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, js.batch_stats)}))
    return js, TrainState(port.to(memory_format=torch.channels_last).eval())


def _eval_items(sizes, seed):
    rng = np.random.default_rng(seed)
    items = []
    for i, (h, w) in enumerate(sizes):
        lab = np.zeros((h, w), np.int32)  # structured, so argmax ties are rare
        lab[h // 3:, : (w + 1) // 2] = 1 + (i % 2)
        lab[: h // 4, w // 2:] = 3
        items.append((rng.uniform(0, 1, (h, w, 3)).astype(np.float32), lab))
    return items


@pytest.mark.parametrize("sizes", [
    [(400, 1), (32, 32), (1, 37), (47, 29), (24, 61), (70, 70), (33, 20)],  # one canvas
    [(30, 28)] * 10 + [(110, 95)] * 9,  # canvas-size buckets
])
def test_per_batch_eval_equals_resident_eval_and_jax(eval_states, monkeypatch, sizes):
    js, ps = eval_states
    items = _eval_items(sizes, seed=len(sizes))
    data = materialize(ArrayDataset(items), SIDE, keep_orig_labels=True)

    def port_eval():
        agg = MetricsHistory(4, ignore_index=3)
        out = loop.evaluate(ps, data, loss_cfg=DiceCELoss(**VAL_CFG), protocol="device",
                            batch_size=4, agg=agg, verbose=False)
        return out, agg.confusion.copy()

    resident, conf_r = port_eval()
    assert data.device_eval_cache is not None or data.bucket_views
    monkeypatch.setenv(EVAL_ENV, "0")
    streamed, conf_s = port_eval()
    assert data.device_eval_cache is None
    assert all(v.device_eval_cache is None for v in data.bucket_views or [])
    np.testing.assert_array_equal(conf_s, conf_r)
    for k in ("loss", "dice", "iou", "acc"):
        assert streamed[k] == resident[k], k

    jagg = JaxMetricsHistory(4, ignore_index=3)
    jax_out = jax_loop.evaluate(js, jax_materialize(JaxArrayDataset(items), SIDE,
                                                    keep_orig_labels=True),
                                loss_cfg=JaxDiceCE(**VAL_CFG), protocol="device", batch_size=4,
                                agg=jagg, verbose=False)
    # integer counts: f32 forwards and inverses in another order could flip
    # an argmax near-tie, none does on these structured labels
    np.testing.assert_array_equal(conf_s, jagg.confusion)
    assert abs(streamed["loss"] - jax_out["loss"]) <= 1e-5


def test_eval_budget_default_and_variable(monkeypatch):
    assert loop.eval_device_budget("cpu") == 4096 * MB

    class Props:
        total_memory = 80 * 10**9

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props())
    assert loop.eval_device_budget(torch.device("cuda", 0)) == 20 * 10**9
    monkeypatch.setenv(EVAL_ENV, "1")
    assert loop.eval_device_budget(torch.device("cuda", 0)) == MB
    assert loop.train_device_budget(torch.device("cuda", 0)) == 20 * 10**9
