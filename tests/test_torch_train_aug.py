"""The trainer's device budget, online augmentation inside `fit`, and the
reconstruction residency.

- `ISTPU_TRAIN_DEVICE_CACHE_MB` is read at call time, as JAX's fit reads
  it (loop.py:801,1080): set below the set's float32 bytes and above a
  quarter of them, `fit` holds the set as uint8; below a quarter it
  streams the set from the host, with the losses of the float32-resident
  fit. Unset, the budget follows the device: a quarter of a card's
  memory, 4096 MB on the CPU.
- `fit(augment_fn=...)` hands the whole step batch (micro × accum rows)
  to the augmenter once per step, with a generator seeded
  `seed * 100003 + epoch` (JAX's `aug_key`, loop.py:861), so a resumed
  run draws what the uninterrupted run drew; heatmap sets refuse it.
"""
import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.data.dataset import ArrayDataset
from image_segmentation_tpu_torch.data.labels import target_remap
from image_segmentation_tpu_torch.data.loader import MaterializedDataset, materialize
from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.autoencoder import ReconstructionAutoencoder
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.ops import augment as A
from image_segmentation_tpu_torch.run import _synthetic_items
from image_segmentation_tpu_torch.train import loop
from image_segmentation_tpu_torch.train.loop import fit, fit_reconstruction
from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
from image_segmentation_tpu_torch.train.steps import ResidentTrainSet

torch.set_num_threads(1)

SIDE = 32
ENV = "ISTPU_TRAIN_DEVICE_CACHE_MB"


def _items(n, seed):
    return [(img[::4, ::4].copy(), target_remap(lab[::4, ::4]))
            for img, lab in _synthetic_items(n, seed)]


@pytest.fixture(scope="module")
def data():
    return (materialize(ArrayDataset(_items(128, 0)), SIDE),
            materialize(ArrayDataset(_items(4, 1)), SIDE, keep_orig_labels=True))


def _state(seed=0):
    torch.manual_seed(seed)
    model = UNet(base=4).init_weights(torch.Generator().manual_seed(seed))
    model = model.to(memory_format=torch.channels_last)
    return TrainState(model, *make_adamw(model.parameters()))


def _fit(data, tmp_path, **kw):
    train, val = data
    args = dict(loss_fn=DiceCELoss(class_weights=None), epochs=1, batch_size=64,
                accum_steps=8, save_dir=str(tmp_path), name="unet_aug", verbose=False)
    args.update(kw)
    return fit(_state(), train, val, **args)


def _f32_mb(train):
    return (train.images.nbytes + train.labels.nbytes) / 2**20


def test_budget_variable_sets_uint8_residency_and_refusal(data, tmp_path, monkeypatch):
    train, _ = data
    train.device_train_cache = None
    mb = _f32_mb(train)
    monkeypatch.setenv(ENV, str(mb / 2))  # below float32, above a quarter
    _fit(data, tmp_path / "a")
    assert train.device_train_cache[1].quantize
    assert train.device_train_cache[1].images.dtype == torch.uint8
    monkeypatch.setenv(ENV, str(mb / 8))  # below a quarter: streamed from the host
    streamed = _fit(data, tmp_path / "b").history["train_loss"]
    assert train.device_train_cache is None
    monkeypatch.setenv(ENV, str(2 * mb))  # fits as float32
    resident = _fit(data, tmp_path / "c").history["train_loss"]
    assert not train.device_train_cache[1].quantize
    assert streamed == resident


def test_budget_default_follows_the_device(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert loop.train_device_budget("cpu") == 4096 << 20

    class Props:
        total_memory = 80 * 10**9

    seen = []
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: seen.append(d) or Props())
    assert loop.train_device_budget(torch.device("cuda", 0)) == 20 * 10**9
    assert seen == [torch.device("cuda", 0)]
    monkeypatch.setenv(ENV, "8192")
    assert loop.train_device_budget(torch.device("cuda", 0)) == 8192 << 20


def test_reconstruction_residency_shares_one_buffer(data, tmp_path, monkeypatch):
    """Input and target are one buffer, so under uint8 both decode from it
    and stay equal (JAX loop.py:1085-1092); fit_reconstruction takes the
    budget from the variable too (images only)."""
    train, val = data
    images = train.images[:8]
    for quantize in (False, True):
        res = ResidentTrainSet(images, None, "cpu", quantize)
        x, t = res.batch(torch.tensor([3, 1, 3]))
        assert t is x and x.dtype == torch.float32 and x.shape == (3, SIDE, SIDE, 3)
        if quantize:
            np.testing.assert_allclose(x.numpy(), images[[3, 1, 3]], atol=0.5 / 255 + 1e-7)
    recon_train = MaterializedDataset(images=train.images[:16], labels=train.labels[:16],
                                      metas=train.metas)
    monkeypatch.setenv(ENV, str(recon_train.images.nbytes / 2**20 / 2))
    model = ReconstructionAutoencoder(base=4).init_weights(torch.Generator().manual_seed(0))
    st = TrainState(model, make_adamw(model.parameters(), weight_decay=0.0)[0])
    originals = [np.asarray(img) for img, _ in _items(4, 1)]
    fit_reconstruction(st, recon_train, val, originals=originals, epochs=1, batch_size=8,
                       save_dir=str(tmp_path), name="recon_ae", verbose=False)
    key, res = recon_train.device_train_cache
    assert key[1:] == (True, True) and res.labels is None


class Spy:
    """An augment_fn that records what it is handed and the parameters it
    draws, then augments as random_augment_batch does."""

    def __init__(self):
        self.calls = []

    def __call__(self, images, labels, generator):
        p = A.draw_augment_params(images.shape[0], images.shape[1], generator, images.device)
        self.calls.append((tuple(images.shape), tuple(labels.shape), p.sel.clone(),
                           p.use.clone(), p.angle.clone()))
        return A.apply_augment_batch(images, labels, p)


def test_fit_augments_each_whole_step_batch_once(data, tmp_path):
    spy = Spy()
    res = _fit(data, tmp_path, epochs=2, augment_fn=spy)
    # 128 images, step batch 64 (micro 8 x accum 8): 2 steps an epoch
    assert len(spy.calls) == 4 and res.state.step == 4
    assert all(c[0] == (64, SIDE, SIDE, 3) and c[1] == (64, SIDE, SIDE) for c in spy.calls)
    # each step draws anew; the two epochs' generators differ
    assert not torch.equal(spy.calls[0][4], spy.calls[1][4])
    assert not torch.equal(spy.calls[0][4], spy.calls[2][4])
    plain = _fit(data, tmp_path / "plain", epochs=1)
    augmented = _fit(data, tmp_path / "aug", epochs=1, augment_fn=A.random_augment_batch)
    assert plain.history["train_loss"] != augmented.history["train_loss"]


def test_resumed_run_draws_what_the_uninterrupted_run_drew(data, tmp_path):
    whole, split = Spy(), Spy()
    _fit(data, tmp_path / "whole", epochs=2, augment_fn=whole, seed=3)
    _fit(data, tmp_path / "split", epochs=1, augment_fn=split, seed=3)
    _fit(data, tmp_path / "split", epochs=2, augment_fn=split, seed=3, resume=True)
    assert len(whole.calls) == len(split.calls) == 4
    for a, b in zip(whole.calls, split.calls):
        for x, y in zip(a[2:], b[2:]):
            assert torch.equal(x, y)


def test_heatmap_set_with_augmentation_is_refused(data, tmp_path):
    train, val = data
    heat = MaterializedDataset(images=train.images, labels=train.labels, metas=train.metas,
                               heatmaps=train.images[..., :1])
    with pytest.raises(ValueError, match="not supported for prompt \\(heatmap\\) datasets"):
        _fit((heat, val), tmp_path, augment_fn=A.random_augment_batch)
