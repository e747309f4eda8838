"""The port's device eval protocol held against the JAX package's.

`train/fast_eval.py` of the port inverts each image's geometry onto a
static canvas with two interpolation matrices and two batched matmuls;
JAX resamples (scores · crop mask) and divides by the resampled mask
(`_invert_one_to_canvas`). Both are checked against each other and
against JAX's float64 host protocol, on ragged sizes that include 400×1
and an image of exactly the target size, from one JAX UNet carried over
by `models.convert.from_jax_variables`. The bucket plan and the label
canvases must be identical to JAX's. Tolerances are stated beside each
check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from image_segmentation_tpu.data.loader import materialize as jax_materialize
from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
from image_segmentation_tpu.losses import DiceNLLLoss as JaxDiceNLL
from image_segmentation_tpu.losses.host import dice_ce_loss_np as jax_dice_ce_np
from image_segmentation_tpu.models import UNet as JaxUNet
from image_segmentation_tpu.ops import geometry as jax_geometry
from image_segmentation_tpu.train import create_train_state
from image_segmentation_tpu.train import fast_eval as jax_fe
from image_segmentation_tpu.train.loop import evaluate as jax_evaluate
from image_segmentation_tpu.train.state import TrainState as JaxTrainState
from image_segmentation_tpu.train.state import make_adamw as jax_adamw
from image_segmentation_tpu_torch.data.dataset import ArrayDataset
from image_segmentation_tpu_torch.data.loader import materialize
from image_segmentation_tpu_torch.losses import DiceCELoss, DiceNLLLoss
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.ops import geometry as G
from image_segmentation_tpu_torch.train import fast_eval as FE
from image_segmentation_tpu_torch.train.loop import evaluate
from image_segmentation_tpu_torch.train.state import TrainState

torch.set_num_threads(1)

SIDE = 32
# ragged sizes: 400×1 (new_w rounds to 1), exactly the target size, a
# 1-pixel-high image, odd and even sizes around and above the target
SIZES = ((400, 1), (32, 32), (1, 37), (47, 29), (24, 61), (70, 70), (33, 20))
VAL_CFG = dict(ignore_index=3, class_weights=(0.2047, 1.0272, 1.2293, 1.5388),
               smooth_dice=1e-5)


@pytest.fixture(autouse=True)
def jax_numpy_path(monkeypatch):
    """The JAX package on its numpy resampler, so both packages'
    materialised inputs are bit-equal (tests/test_torch_loader.py)."""
    monkeypatch.setattr(jax_geometry, "_native", lambda: None)


@pytest.fixture(scope="module")
def states():
    model = JaxUNet(num_classes=4, base=8, dtype=jnp.float32)
    js = create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)),
                            jax_adamw(1e-3))
    # BN statistics off 0 and 1, so the eval forward's BN does work
    rng = np.random.default_rng(9)
    bs = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        js.batch_stats)
    js = js.replace(batch_stats=bs)
    port = UNet(base=8)
    port.load_state_dict(from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, js.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, js.batch_stats)}))
    return js, TrainState(port.to(memory_format=torch.channels_last).eval())


def _items(sizes, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for i, (h, w) in enumerate(sizes):
        img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        lab = np.zeros((h, w), np.int32)  # structured, so argmax ties are rare
        lab[h // 3:, : (w + 1) // 2] = 1 + (i % 2)
        lab[: h // 4, w // 2:] = 3
        items.append((img, lab))
    return items


def _both(items):
    return (materialize(ArrayDataset(items), SIDE, keep_orig_labels=True),
            jax_materialize(JaxArrayDataset(items), SIDE, keep_orig_labels=True))


def _bimodal(n=20, seed=5):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(90, 120)), int(rng.integers(90, 120))) if i >= n // 2
            else (int(rng.integers(24, 40)), int(rng.integers(24, 40))) for i in range(n)]


@pytest.mark.parametrize("sizes", [
    [(32, 32)] * 12 + [(300, 280)] * 12,  # two buckets
    [(64, 64)] * 30,  # one
    [(32, 32)] * 20 + [(400, 400)],  # an outlier cannot form its own bucket
    [(32, 32), (300, 300)],  # too few to split
    _bimodal(40, seed=1),
    [(int(h), int(w)) for h, w in np.random.default_rng(3).integers(1, 300, (57, 2))],
])
def test_plan_size_buckets_identical_to_jax(sizes):
    labels = [np.zeros(s, np.int32) for s in sizes]
    got, want = FE.plan_size_buckets(labels), jax_fe.plan_size_buckets(labels)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pack_label_canvases_identical_to_jax():
    labels = [np.random.default_rng(i).integers(0, 4, s).astype(np.int32)
              for i, s in enumerate(SIZES)]
    got = FE.pack_label_canvases(labels)
    np.testing.assert_array_equal(got, jax_fe.pack_label_canvases(labels))
    assert got.dtype == np.uint8 and got.shape == (len(SIZES), 400, 72)


def test_inverse_onto_the_canvas_matches_jax():
    """Each image's native-resolution scores inside [0:h, 0:w] against
    `_invert_one_to_canvas`: the same triangle weights renormalised over
    the in-crop taps, f32 sums in another order: 1e-5 absolute and 1e-5
    relative on N(0, 1) scores (the largest seen 1.1e-5 on a score of 2)."""
    port_data, _ = _both(_items(SIZES))
    metas = port_data.metas
    canvas = FE.pack_label_canvases(port_data.orig_labels).shape[1:]
    scores = np.random.default_rng(1).normal(size=(len(SIZES), SIDE, SIDE, 4)).astype(np.float32)
    got = FE.invert_to_canvas(torch.from_numpy(scores), {
        f: torch.from_numpy(np.asarray(v).astype(np.int64))
        for f, v in metas._asdict().items() if f != "scale"}, canvas).numpy()
    for i, (h, w) in enumerate(SIZES):
        meta = jax_geometry.ResizeMeta(*(jnp.asarray(np.asarray(f)[i]) for f in metas))
        want = np.asarray(jax_fe._invert_one_to_canvas(jnp.asarray(scores[i]), meta, canvas))
        np.testing.assert_allclose(got[i, :h, :w], want[:h, :w], rtol=1e-5, atol=1e-5,
                                   err_msg=str((h, w)))
        # and the host inverse of the reference protocol (float32 numpy)
        host = G.invert_resize_padding_np(scores[i], G.metas_to_list(metas)[i])
        np.testing.assert_allclose(got[i, :h, :w], host, rtol=1e-5, atol=1e-5, err_msg=str((h, w)))


@pytest.mark.parametrize("cfg", ["ce", "nll"])
def test_masked_loss_matches_jax(cfg):
    """The per-image masked loss on a canvas with FILL outside the image,
    batched, against JAX's vmapped `make_masked_loss`: 1e-5."""
    rng = np.random.default_rng(2)
    b, h, w = 3, 24, 20
    scores = rng.normal(size=(b, h, w, 4)).astype(np.float32)
    if cfg == "nll":
        scores = np.exp(scores) / np.exp(scores).sum(-1, keepdims=True)
    labels = rng.integers(0, 4, (b, h, w)).astype(np.int32)
    labels[0, 10:, :] = FE.FILL
    labels[1, :, 15:] = FE.FILL
    labels[2, labels[2] == 2] = 0  # an absent class
    valid = labels != FE.FILL
    port_cfg, jax_cfg = ((DiceCELoss(**VAL_CFG), JaxDiceCE(**VAL_CFG)) if cfg == "ce"
                         else (DiceNLLLoss(**VAL_CFG), JaxDiceNLL(**VAL_CFG)))
    got = FE.make_masked_loss(port_cfg)(torch.from_numpy(scores), torch.from_numpy(labels).long(),
                                        torch.from_numpy(valid)).numpy()
    want = np.asarray(jax.vmap(jax_fe.make_masked_loss(jax_cfg))(
        jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_eval_batch_drops_fill_and_out_of_range_labels_and_padded_rows():
    """Confusion counts with FILL pixels, a label of 200 and a repeated
    tail row: exactly JAX's `_eval_batch_core` on identity geometry."""
    t, c = 16, 4
    pred = np.zeros((t, t), np.int64)
    pred[:, t // 2:] = 2
    scores = np.full((2, t, t, c), -5.0, np.float32)
    for k in range(c):
        scores[:, pred == k, k] = 5.0
    labels = np.zeros((2, t, t), np.uint8)
    labels[:, : t // 2] = 1
    labels[:, 0, 0] = 200
    labels[:, -1, -1] = FE.FILL
    meta = {f: torch.full((2,), v) for f, v in
            (("orig_h", t), ("orig_w", t), ("new_h", t), ("new_w", t), ("pad_top", 0),
             ("pad_left", 0))}
    conf, losses = FE.eval_batch(torch.from_numpy(scores), meta, torch.from_numpy(labels),
                                 torch.tensor([True, False]), c)
    assert conf.dtype == torch.int64 and int(conf.sum()) == t * t - 2
    assert int(conf[3].sum()) == 0 and torch.isnan(losses).all()
    jmeta = jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None].repeat(2, 0),
                                   jax_geometry.compute_meta(t, t, t))
    # JAX's core runs the model itself: give it an identity model
    ident = JaxTrainState(step=0, params={}, batch_stats={}, opt_state=None,
                          apply_fn=lambda variables, x, train: x, tx=None)
    want, _ = jax_fe._eval_batch_core(
        ident, (jnp.asarray(scores),), jmeta, jnp.asarray(labels).astype(jnp.int32),
        jnp.asarray([True, False]), (t, t), c, None)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(want))


def _check_against_jax(port, jax_dev, jax_host):
    # device against device: both f32, the inverse summed in another order;
    # an argmax near-tie could flip a pixel, none does here: 1e-6 on the
    # metrics, 1e-5 on the loss (a mean of per-image f32 losses)
    for k in ("dice", "iou", "acc"):
        assert abs(port[k] - jax_dev[k]) <= 1e-6, (k, port[k], jax_dev[k])
    assert abs(port["loss"] - jax_dev["loss"]) <= 1e-5
    np.testing.assert_allclose(port["per_class_iou"], jax_dev["per_class_iou"], atol=1e-6)
    # against the float64 host protocol: mIoU within 1e-4, the loss within
    # 1e-4 (f32 inverse and loss against float64)
    assert abs(port["iou"] - jax_host["iou"]) <= 1e-4, (port["iou"], jax_host["iou"])
    assert abs(port["loss"] - jax_host["loss"]) <= 1e-4


@pytest.mark.parametrize("batch", [4, 7])
def test_device_protocol_matches_jax_device_and_host(states, batch):
    """Ragged sizes (400×1, exactly 32×32, 1×37), one canvas of 400×72,
    the last batch padded (7 images in batches of 4) or not."""
    js, ps = states
    port_data, jax_data = _both(_items(SIZES))
    port = evaluate(ps, port_data, loss_cfg=DiceCELoss(**VAL_CFG), protocol="device",
                    batch_size=batch, verbose=False)
    jax_dev = jax_evaluate(js, jax_data, loss_cfg=JaxDiceCE(**VAL_CFG), protocol="device",
                           batch_size=batch, verbose=False)
    jcfg = JaxDiceCE(**VAL_CFG)
    jax_host = jax_evaluate(js, jax_data, host_loss_fn=lambda s, l: jax_dice_ce_np(s, l, jcfg),
                            protocol="host", batch_size=batch, verbose=False)
    _check_against_jax(port, jax_dev, jax_host)


def test_bucketed_device_protocol_matches_jax(states):
    """20 images of two size groups: the port and JAX split them into the
    same canvas buckets, and the metrics agree as above."""
    js, ps = states
    items = _items(_bimodal(20) + [(400, 1)], seed=3)
    port_data, jax_data = _both(items)
    port = evaluate(ps, port_data, loss_cfg=DiceCELoss(**VAL_CFG), protocol="device",
                    batch_size=4, verbose=False)
    assert len(port_data.bucket_views) >= 2
    jax_dev = jax_evaluate(js, jax_data, loss_cfg=JaxDiceCE(**VAL_CFG), protocol="device",
                           batch_size=4, verbose=False)
    assert [len(v) for v in port_data.bucket_views] == [len(v) for v in jax_data.bucket_views]
    jcfg = JaxDiceCE(**VAL_CFG)
    jax_host = jax_evaluate(js, jax_data, host_loss_fn=lambda s, l: jax_dice_ce_np(s, l, jcfg),
                            protocol="host", batch_size=4, verbose=False)
    _check_against_jax(port, jax_dev, jax_host)


def test_host_protocol_matches_jax_host(states):
    """The port's float64 host protocol against JAX's: the same numpy
    arithmetic on f32 scores that differ by f32 rounding: 1e-5."""
    js, ps = states
    port_data, jax_data = _both(_items(SIZES, seed=4))
    from image_segmentation_tpu_torch.losses.host import dice_ce_loss_np

    pcfg, jcfg = DiceCELoss(**VAL_CFG), JaxDiceCE(**VAL_CFG)
    port = evaluate(ps, port_data, host_loss_fn=lambda s, l: dice_ce_loss_np(s, l, pcfg),
                    protocol="host", batch_size=4, verbose=False)
    want = jax_evaluate(js, jax_data, host_loss_fn=lambda s, l: jax_dice_ce_np(s, l, jcfg),
                        protocol="host", batch_size=4, verbose=False)
    for k in ("dice", "iou", "acc", "loss"):
        assert abs(port[k] - want[k]) <= 1e-5, (k, port[k], want[k])
