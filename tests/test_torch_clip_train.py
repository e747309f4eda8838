"""The port's CLIP training modules held against the JAX package's, with
the same weights (`models.convert.from_jax_variables`) and seeded numpy
inputs, at run.py's `--smoke-vit` widths (ViT hidden 64, 4 layers, 4
heads, MLP 128; skips (1, 2, 3, 4); decoder (64, 32, 16, 8, 8)) at 64 px,
f32 on the CPU:

- `ClipUNetNoSkips` and `ClipUNetDecoderOnly`, eval and train-mode
  forwards (the train-mode running statistics too), and the converter's
  dispatch on their trees;
- the decoder-only forward against the port's own full ClipUNet;
- `encode_clip_features` against JAX's, a padded last batch and an empty
  split included;
- one frozen train step of the no-skip model against `jax.grad`, and the
  decoder-only step against the in-line frozen step;
- the residency of a feature set past the budget: the port refuses it,
  where JAX's plan quantises it to uint8 and wipes out its negative values
  (a reference-side defect, stated here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
from image_segmentation_tpu.models.clip_unet import ClipUNet as JaxClipUNet
from image_segmentation_tpu.models.clip_unet import ClipUNetDecoderOnly as JaxDecoderOnly
from image_segmentation_tpu.models.clip_unet import ClipUNetNoSkips as JaxNoSkips
from image_segmentation_tpu.models.clip_vit import ClipViTConfig as JaxViTConfig
from image_segmentation_tpu.train import feature_cache as jax_fc
from image_segmentation_tpu.train import loop as jax_loop
from image_segmentation_tpu_torch.data.loader import materialize
from image_segmentation_tpu_torch.data.dataset import ArrayDataset
from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.clip_unet import (
    ClipUNet,
    ClipUNetDecoderOnly,
    ClipUNetNoSkips,
)
from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.train import feature_cache as FC
from image_segmentation_tpu_torch.train import loop
from image_segmentation_tpu_torch.train.state import TrainState, make_adamw, trainable_parameters
from image_segmentation_tpu_torch.train.steps import train_step

torch.set_num_threads(1)

SIDE = 64
VIT = dict(image_size=SIDE, patch_size=16, hidden_size=64, num_layers=4, num_heads=4,
           mlp_dim=128)
SKIPS = (1, 2, 3, 4)
CHANS = (64, 32, 16, 8, 8)
# f32 on both sides: a 4-block ViT and a 4-block decoder, the same sums in
# another order. Logits (up to ~12 in magnitude) within 2e-5 of the
# largest: the train-mode forwards, normalising 2-image batches, reach
# 6.6e-6 of it (5.4e-5 absolute), the eval ones 1.7e-6
REL = 2e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())


def _perturbed(v, seed):
    """Parameters moved off their init, BN statistics off 0 and 1."""
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)
    return {"params": jax.tree_util.tree_map(
                lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), v["params"]),
            "batch_stats": jax.tree_util.tree_map(
                lambda a: (a + rng.uniform(0.0, 0.5, a.shape)).astype(np.float32),
                v["batch_stats"])}


def _pixels(n=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, SIDE, SIDE, 3)).astype(np.float32)


def _jax_model(kind):
    vit = JaxViTConfig(**VIT)
    if kind == "noskips":
        return JaxNoSkips(vit=vit, decoder_channels=CHANS)
    return JaxClipUNet(vit=vit, skip_indices=SKIPS, decoder_channels=CHANS)


def _port_model(kind, variables):
    vit = ClipViTConfig(**VIT)
    if kind == "noskips":
        model = ClipUNetNoSkips(vit=vit, decoder_channels=CHANS)
    else:
        model = ClipUNet(vit=vit, skip_indices=SKIPS, decoder_channels=CHANS)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model.to(memory_format=torch.channels_last)


@pytest.fixture(scope="module", params=["clipunet", "noskips"])
def weights(request):
    model = _jax_model(request.param)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)))
    return request.param, model, _perturbed(v, 1)


def _decoder_only(variables):
    """JAX's decoder-only module and variables for a ClipUNet's."""
    dec = JaxDecoderOnly(decoder_channels=CHANS, num_skips=len(SKIPS))
    return dec, {"params": jax_fc.decoder_params_from_clipunet(variables["params"]),
                 "batch_stats": variables["batch_stats"]}


def _jax_features(variables, x, batch_size=2):
    return jax_fc.encode_clip_features(variables["params"]["encoder"], x, JaxViTConfig(**VIT),
                                       skip_indices=SKIPS, batch_size=batch_size)


def _assert_stats_equal(port, want_stats):
    want = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, want_stats[0]),
                               "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                     want_stats[1])})
    got = port.state_dict()
    running = [k for k in want if "running" in k]
    assert running
    for k in running:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(weights, train):
    """ClipUNet and ClipUNetNoSkips, eval (running statistics) and train
    mode (batch statistics; the updated running statistics within 1e-5,
    7.2e-6 seen), logits within REL of the largest."""
    kind, model, v = weights
    x = _pixels()
    port = _port_model(kind, v).train(train)
    if train:
        want, mutated = model.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = model.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (2, SIDE, SIDE, 4) and got.dtype == torch.float32
    _close(got.numpy(), want)
    if train:
        _assert_stats_equal(port, (v["params"], mutated["batch_stats"]))


@pytest.mark.parametrize("train", [False, True])
def test_decoder_only_matches_jax_on_jax_features(train):
    """The port's ClipUNetDecoderOnly fed JAX's packed features as they are
    ((N, 1 + S, G, G, H), NHWC), against JAX's decoder-only module."""
    model = _jax_model("clipunet")
    v = _perturbed(model.init(jax.random.PRNGKey(2), jnp.zeros((1, SIDE, SIDE, 3))), 2)
    feats = _jax_features(v, _pixels(3, seed=2))
    dec, dv = _decoder_only(v)
    if train:
        want, mutated = dec.apply(dv, jnp.asarray(feats), train=True, mutable=["batch_stats"])
    else:
        want = dec.apply(dv, jnp.asarray(feats), train=False)
    port = ClipUNetDecoderOnly(decoder_channels=CHANS, num_skips=len(SKIPS),
                               hidden_size=VIT["hidden_size"])
    port.load_state_dict(from_jax_variables(dv), strict=True)
    port = port.to(memory_format=torch.channels_last).train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(feats))
    _close(got.numpy(), want)
    if train:
        _assert_stats_equal(port, (dv["params"], mutated["batch_stats"]))


@pytest.mark.parametrize("kind", ["noskips", "decoder_only"])
def test_convert_dispatches_on_the_new_trees(kind):
    """A ClipUNetNoSkips tree (blocks without skip_proj) and a decoder-only
    tree (init_conv, no encoder) convert to exactly their port module's
    state dict (strict); every converted value is a JAX one."""
    jm = _jax_model("noskips" if kind == "noskips" else "clipunet")
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, SIDE, SIDE, 3))))
    if kind == "noskips":
        port = ClipUNetNoSkips(vit=ClipViTConfig(**VIT), decoder_channels=CHANS)
    else:
        _, v = _decoder_only(v)
        port = ClipUNetDecoderOnly(decoder_channels=CHANS, num_skips=len(SKIPS),
                                   hidden_size=VIT["hidden_size"])
    sd = from_jax_variables(v)
    port.load_state_dict(sd, strict=True)
    leaves = jax.tree_util.tree_leaves(v)
    assert len(sd) == len(leaves)
    assert sum(t.numel() for t in sd.values()) == sum(a.size for a in leaves)


@pytest.mark.parametrize("train", [False, True])
def test_decoder_only_view_equals_the_full_forward(train):
    """`ClipUNet.decoder_only()` shares the ClipUNet's decoder modules: on
    the features `encode_clip_features` gives, its logits are the full
    forward's, bit for bit, and its state dict is the ClipUNet's without
    the ViT, the same tensors."""
    model = _jax_model("clipunet")
    v = _perturbed(model.init(jax.random.PRNGKey(3), jnp.zeros((1, SIDE, SIDE, 3))), 3)
    full = _port_model("clipunet", v)
    dec = full.decoder_only()
    x = _pixels(4, seed=3)
    feats = FC.encode_clip_features(full, x, batch_size=4)
    with torch.no_grad():
        want = full.train(train)(torch.from_numpy(x))
        got = dec.train(train)(torch.from_numpy(feats))
    assert torch.equal(got, want)
    sd, whole = dec.state_dict(), full.state_dict()
    assert sd.keys() == {k for k in whole if not k.startswith("vision_model.")}
    assert all(sd[k].data_ptr() == whole[k].data_ptr() for k in sd)


@pytest.mark.parametrize("n,batch", [(5, 2), (4, 4), (0, 2)])
def test_encode_clip_features_matches_jax(n, batch):
    """Fixed-size batches with the last one padded (5 images in batches of
    2), one exact batch, and an empty split, which gives (0, 1 + S, G, G,
    H) float32 on both sides. f32 hidden states up to ~9.4 through 4
    blocks: within 5e-5 (5.7e-6 seen)."""
    model = _jax_model("clipunet")
    v = _perturbed(model.init(jax.random.PRNGKey(4), jnp.zeros((1, SIDE, SIDE, 3))), 4)
    x = _pixels(n, seed=4)
    want = _jax_features(v, x, batch)
    got = FC.encode_clip_features(_port_model("clipunet", v), x, batch_size=batch)
    g = SIDE // 16
    assert got.shape == want.shape == (n, 1 + len(SKIPS), g, g, VIT["hidden_size"])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_frozen_no_skip_train_step_matches_jax_grad():
    """One `train_step` of ClipUNetNoSkips(freeze_encoder=True) in train
    mode on the CPU: no `vision_model` parameter gets a .grad, and every
    decoder gradient matches jax.grad of the JAX ClipUNetNoSkips on the
    same weights and batch (batch statistics, Dice + CE with the train
    smooth 1), relative L2 ≤ 1e-4 per tensor."""
    model = _jax_model("noskips")
    v = _perturbed(model.init(jax.random.PRNGKey(5), jnp.zeros((1, SIDE, SIDE, 3))), 5)
    x = _pixels(seed=5)
    y = np.random.default_rng(5).integers(0, 4, (2, SIDE, SIDE)).astype(np.int32)

    def loss(params):
        out, _ = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                             jnp.asarray(x), train=True, mutable=["batch_stats"])
        return JaxDiceCE(smooth_dice=1.0)(out, jnp.asarray(y))

    jgrad = jax.grad(loss)(v["params"])
    assert all(not np.any(np.asarray(g)) for g in jax.tree_util.tree_leaves(jgrad["encoder"]))
    want = {k: t.numpy() for k, t in from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jgrad),
         "batch_stats": v["batch_stats"]}).items()}
    port = _port_model("noskips", v)
    assert port.freeze_encoder
    st = TrainState(port, *make_adamw(port.parameters()))
    train_step(st, DiceCELoss(smooth_dice=1.0), torch.from_numpy(x), torch.from_numpy(y).long())
    decoder = 0
    for name, p in port.named_parameters():
        if name.startswith("vision_model."):
            assert p.grad is None, name
            continue
        decoder += 1
        assert _rel(p.grad.numpy(), want[name]) <= 1e-4, (name, _rel(p.grad.numpy(), want[name]))
    assert decoder == sum(1 for k in want if not k.startswith("vision_model.")
                          and "running" not in k)


def test_decoder_only_step_equals_the_in_line_frozen_step():
    """From the same weights, one step (micro 2 x accum 2) of the frozen
    ClipUNet on images and one of its decoder-only view on the features of
    the same images (encoded in batches of the micro-batch): the same loss
    and every decoder gradient, bit for bit, and the same parameters and
    running statistics after AdamW."""
    model = _jax_model("clipunet")
    v = _perturbed(model.init(jax.random.PRNGKey(6), jnp.zeros((1, SIDE, SIDE, 3))), 6)
    x = _pixels(4, seed=6)
    y = torch.from_numpy(np.random.default_rng(6).integers(0, 4, (4, SIDE, SIDE)))
    loss_fn = DiceCELoss(smooth_dice=1.0)

    full = _port_model("clipunet", v)
    st = TrainState(full, *make_adamw(trainable_parameters(full, ("vision_model",))))
    inline = train_step(st, loss_fn, torch.from_numpy(x), y, 2)

    base = _port_model("clipunet", v)
    feats = FC.encode_clip_features(base, x, batch_size=2)
    dec = base.decoder_only()
    sd = TrainState(dec, *make_adamw(dec.parameters()))
    cached = train_step(sd, loss_fn, torch.from_numpy(feats), y, 2)

    assert torch.equal(inline, cached)
    named = dict(full.named_parameters())
    n = 0
    for name, p in dec.named_parameters():
        assert torch.equal(p.grad, named[name].grad), name
        n += 1
    assert n == len(trainable_parameters(full, ("vision_model",)))
    a, b = full.state_dict(), base.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_feature_set_past_the_budget_is_refused_never_quantised(monkeypatch, tmp_path):
    """A feature set whose float32 bytes exceed the budget while a quarter of
    them fits: `fit` holds no uint8 copy on the device, it streams the
    float32 features from the host (`resident_plan` → 'stream'), and
    trains as the float32-resident fit from the same weights does, loss
    for loss. JAX's fit plans uint8 residency for the same set
    (`_resident_plan` → (True, True)), and its `_quantize_u8` clips every
    negative feature to 0 and every one above 1 to 255: the reference-side
    defect the port does not copy. The same set inside the budget trains,
    held as float32."""
    model = _jax_model("clipunet")
    v = _perturbed(model.init(jax.random.PRNGKey(7), jnp.zeros((1, SIDE, SIDE, 3))), 7)
    port = _port_model("clipunet", v)
    rng = np.random.default_rng(7)
    items = [(rng.uniform(0, 1, (SIDE, SIDE, 3)).astype(np.float32),
              rng.integers(0, 4, (SIDE, SIDE)).astype(np.int32)) for _ in range(4)]
    data = materialize(ArrayDataset(items), SIDE)
    feats = FC.encode_clip_features(port, data.images, batch_size=4)
    assert feats.min() < 0 and feats.max() > 1
    train = FC.features_dataset(data, feats)
    nbytes = train.images.nbytes + train.labels.nbytes
    budget_mb = nbytes / 2 / 2**20  # past the budget; a quarter of the set fits
    monkeypatch.setenv(loop.BUDGET_ENV, str(budget_mb))
    budget = int(budget_mb * 2**20)
    assert jax_loop._resident_plan("auto", nbytes, budget) == (True, True)
    q = jax_loop._quantize_u8(feats)
    assert np.all(q[feats < 0] == 0) and np.all(q[feats > 1] == 255)

    assert loop.resident_plan(nbytes, budget, quantizable=False) == "stream"
    init = {k: v.clone() for k, v in port.state_dict().items()}
    val = materialize(ArrayDataset(items), SIDE, keep_orig_labels=True)
    kw = dict(loss_fn=DiceCELoss(smooth_dice=1.0), epochs=1, batch_size=4, name="clipunet",
              verbose=False, eval_state_fn=lambda s: TrainState(port, s.optimizer, None, s.step))

    def fit(save_dir):
        port.load_state_dict(init)
        dec = port.decoder_only()
        st = TrainState(dec, *make_adamw(dec.parameters()))
        return loop.fit(st, train, val, save_dir=str(tmp_path / save_dir), **kw)

    streamed = fit("a").history
    assert train.device_train_cache is None

    monkeypatch.setenv(loop.BUDGET_ENV, str(2 * nbytes / 2**20))
    resident_run = fit("b").history
    resident = train.device_train_cache[1]
    assert not resident.quantize and resident.images.dtype == torch.float32
    assert torch.equal(resident.images, torch.from_numpy(feats))
    assert streamed["train_loss"] == resident_run["train_loss"]
