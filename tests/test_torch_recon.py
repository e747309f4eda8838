"""The two-stage autoencoder held against the JAX package's.

- `ReconstructionAutoencoder` forward, eval and train mode, at base 8 and
  64 px, from a JAX init carried across by `from_jax_variables`.
- One `fit_reconstruction` epoch's train MSE and `evaluate_reconstruction`
  against JAX's on the same weights and data.
- Stage 2: `load_subtree` carries the recon checkpoint's encoder,
  parameters and BN statistics, into a SegmentationAutoencoder; two frozen
  train steps leave its parameters as they were and move its BN
  statistics; the decoder's gradients match `jax.grad` of JAX's masked
  step (JAX masks the encoder out of the optimizer, state.py:72-75, and
  its gradient does not reach the decoder's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from image_segmentation_tpu.data.loader import materialize as jax_materialize
from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
from image_segmentation_tpu.models import ReconstructionAutoencoder as JaxRecon
from image_segmentation_tpu.models import SegmentationAutoencoder as JaxSegAE
from image_segmentation_tpu.ops import geometry as jax_geometry
from image_segmentation_tpu.train import create_train_state
from image_segmentation_tpu.train import loop as jax_loop
from image_segmentation_tpu.train.state import make_adamw as jax_adamw
from image_segmentation_tpu.train.state import subtree_mask
from image_segmentation_tpu_torch import config as C
from image_segmentation_tpu_torch.data.dataset import ArrayDataset
from image_segmentation_tpu_torch.data.labels import target_remap
from image_segmentation_tpu_torch.data.loader import materialize
from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.autoencoder import (
    ReconstructionAutoencoder,
    SegmentationAutoencoder,
)
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.ops import geometry as port_geometry
from image_segmentation_tpu_torch.run import _synthetic_items
from image_segmentation_tpu_torch.train import checkpoint as ckpt
from image_segmentation_tpu_torch.train.loop import evaluate_reconstruction, fit_reconstruction
from image_segmentation_tpu_torch.train.state import TrainState, freeze_, make_adamw
from image_segmentation_tpu_torch.train.steps import train_step

torch.set_num_threads(1)

BASE, SIDE, LR = 8, 64, 1e-3
# eval mode: f32 both sides, 20 conv layers, a sigmoid output in (0, 1),
# the same sums in another order
ATOL = 1e-5
# train mode: each of the 18 BatchNorms normalises with its batch's own
# statistics, and the f32 forward of either package lands 2e-5 to 4e-5
# from the float64 forward of the same weights (seen for 2 and 4 images,
# flax taking the variance as E[x²] − E[x]²): the two f32 forwards differ
# by as much (2.3e-5 to 3.6e-5 seen). Held: 1e-4 between them, and the
# port no further from float64 than twice JAX's distance.
TRAIN_ATOL = 1e-4


def _pixels(n=2, side=SIDE, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, side, side, 3)).astype(np.float32)


def _jax_init(model, seed=0):
    """Variables whose BN statistics moved off 0 and 1 (one train apply)."""
    x = jnp.asarray(_pixels(seed=100 + seed))
    v = model.init(jax.random.PRNGKey(seed), x, train=False)
    _, mut = model.apply(v, x, train=True, mutable=["batch_stats"])
    return jax.tree_util.tree_map(np.asarray, {"params": v["params"],
                                               "batch_stats": mut["batch_stats"]})


@pytest.fixture(scope="module")
def recon_init():
    return _jax_init(JaxRecon(base=BASE))


def _port(cls, variables):
    m = cls(base=BASE)
    m.load_state_dict(from_jax_variables(variables), strict=True)
    return m.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("train", [False, True])
def test_recon_forward_matches_jax(recon_init, train):
    x = _pixels(seed=1)
    out = JaxRecon(base=BASE).apply(recon_init, jnp.asarray(x), train=train,
                                    mutable=["batch_stats"] if train else False)
    want, stats = (out[0], out[1]["batch_stats"]) if train else (out, None)
    port = _port(ReconstructionAutoencoder, recon_init).train(train)
    with torch.set_grad_enabled(train):
        got = port(torch.from_numpy(x))
    assert got.shape == (2, SIDE, SIDE, 3) and got.dtype == torch.float32
    got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=TRAIN_ATOL if train else ATOL)
    if train:
        exact = _port(ReconstructionAutoencoder, recon_init).double().train()
        exact.dtype = torch.float64
        with torch.no_grad():
            ref = exact(torch.from_numpy(x).double()).numpy()
        assert np.abs(got - ref).max() <= 2 * np.abs(np.asarray(want) - ref).max()
        # the running statistics moved as flax's did
        moved = from_jax_variables({"params": recon_init["params"],
                                    "batch_stats": jax.tree_util.tree_map(np.asarray, stats)})
        for k, v in port.state_dict().items():
            if "running" in k:
                # (running statistics of order 1, as tests/test_torch_unet.py holds them)
                np.testing.assert_allclose(v.numpy(), moved[k].numpy(), atol=1e-5, err_msg=k)


def test_full_width_recon_has_the_jax_parameters_and_encoder_keys():
    """base 64: every JAX parameter and statistic has its counterpart, and
    the encoder's keys are the SegmentationAutoencoder's."""
    shapes = jax.eval_shape(JaxRecon().init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    leaves = jax.tree_util.tree_leaves(shapes)
    sd = ReconstructionAutoencoder().state_dict()
    assert sum(a.size for a in leaves) == sum(t.numel() for t in sd.values())
    assert len(leaves) == len(sd)
    enc = lambda d: {k: tuple(v.shape) for k, v in d.items() if k.startswith("encoder.")}  # noqa
    assert enc(sd) == enc(SegmentationAutoencoder().state_dict())
    model = C.build_model(C.RECON_AE, "cpu", torch.Generator().manual_seed(0), base=BASE)
    assert isinstance(model, ReconstructionAutoencoder) and not model.training


def _data():
    """The run.py synthetic task at small sizes, 16 train and 6 val."""
    def items(n, seed):
        return [(img[::4, ::4].copy(), target_remap(lab[::4, ::4]))
                for img, lab in _synthetic_items(n, seed)]
    return items(16, 0), items(6, 1)


def _jax_recon_state(variables):
    tx = jax_adamw(learning_rate=LR, weight_decay=0.0)
    st = create_train_state(JaxRecon(base=BASE), jax.random.PRNGKey(0),
                            jnp.zeros((1, SIDE, SIDE, 3)), tx)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return st.replace(params=params, opt_state=tx.init(params),
                      batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                         variables["batch_stats"]))


def _port_recon_state(variables):
    model = _port(ReconstructionAutoencoder, variables)
    return TrainState(model, make_adamw(model.parameters(), learning_rate=LR,
                                        weight_decay=0.0)[0])


def test_fit_reconstruction_epoch_and_eval_match_jax(recon_init, tmp_path, monkeypatch):
    """The val MSE of the same weights: 1e-6 relative (f32 forwards, the
    same float32 inverse and mean). One epoch (2 steps of micro 4 × accum
    2, JAX's shuffle seed + start_epoch) from the same init: its train MSE,
    the mean of step 1 (identical up to f32 sums) and step 2 (one Adam
    update later), within 1e-4 relative, and the epoch's val MSE too."""
    monkeypatch.setattr(jax_geometry, "_native", lambda: None)  # the numpy resamplers
    monkeypatch.setattr(port_geometry, "_native", lambda: None)
    train, val = _data()
    originals = [img for img, _ in val]
    jtrain = jax_materialize(JaxArrayDataset(train), SIDE)
    jval = jax_materialize(JaxArrayDataset(val), SIDE, keep_orig_labels=True)
    ptrain = materialize(ArrayDataset(train), SIDE)
    pval = materialize(ArrayDataset(val), SIDE, keep_orig_labels=True)

    want0 = jax_loop.evaluate_reconstruction(_jax_recon_state(recon_init), jval,
                                             originals=originals, batch_size=4, verbose=False)
    got0 = evaluate_reconstruction(_port_recon_state(recon_init), pval, originals=originals,
                                   batch_size=4, verbose=False)
    np.testing.assert_allclose(got0, want0, rtol=1e-6)

    kw = dict(originals=originals, epochs=1, batch_size=8, accum_steps=2, name="recon_ae",
              seed=5, verbose=False)
    want = jax_loop.fit_reconstruction(_jax_recon_state(recon_init), jtrain, jval,
                                       save_dir=str(tmp_path / "jax"), **kw).history
    res = fit_reconstruction(_port_recon_state(recon_init), ptrain, pval,
                             save_dir=str(tmp_path / "port"), **kw)
    got = res.history
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    assert res.state.step == 2 and res.best == {"loss": got["val_loss"][0]}
    # the best checkpoint at `name` only, and a resume reads it
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["metrics", "recon_ae"]
    again = fit_reconstruction(_port_recon_state(recon_init), ptrain, pval,
                               save_dir=str(tmp_path / "port"), resume=True,
                               **dict(kw, epochs=2))
    assert len(again.history["train_loss"]) == 2 and again.state.step == 4


def _seg_batch(n=4, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, SIDE, SIDE, 3)).astype(np.float32),
            rng.integers(0, 4, (n, SIDE, SIDE)).astype(np.int32))


@pytest.fixture()
def transferred(recon_init, tmp_path):
    """A recon checkpoint (the JAX init's weights) and a SegmentationAutoencoder
    of another init that took its encoder."""
    recon = _port(ReconstructionAutoencoder, recon_init)
    ckpt.save_params_only(str(tmp_path / "MO_recon"), recon.state_dict())
    seg_init = _jax_init(JaxSegAE(num_classes=4, base=BASE), seed=1)
    seg = _port(SegmentationAutoencoder, seg_init)
    n = ckpt.load_subtree(str(tmp_path / "MO_recon"), seg, "encoder", "encoder")
    return recon, seg, seg_init, n


def test_load_subtree_carries_parameters_and_bn_statistics(transferred, tmp_path):
    recon, seg, _, n = transferred
    src = {k: v for k, v in recon.state_dict().items() if k.startswith("encoder.")}
    assert n == len(src) and any("running_var" in k for k in src)
    dst = seg.state_dict()
    for k, v in src.items():
        assert torch.equal(dst[k], v), k
    # a full checkpoint works too; a key or shape mismatch raises
    st = TrainState(recon)
    ckpt.save_checkpoint_async(w := ckpt.CheckpointWriter(), str(tmp_path / "full"), st,
                               epoch=0)
    w.wait()
    assert ckpt.load_subtree(str(tmp_path / "full"), seg, "encoder", "encoder") == n
    with pytest.raises(KeyError, match="no destination"):
        ckpt.load_subtree(str(tmp_path / "full"), seg, "decoderOut", "decoderOut")
    wide = ReconstructionAutoencoder(base=2 * BASE)
    ckpt.save_params_only(str(tmp_path / "wide"), wide.state_dict())
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_subtree(str(tmp_path / "wide"), seg, "encoder", "encoder")
    with pytest.raises(KeyError, match="no keys"):
        ckpt.load_subtree(str(tmp_path / "full"), seg, "nothing", "encoder")


def _jax_f64_grads(jax_vars, x, y, loss_kw):
    """jax.grad of JAX's step loss in float64: JAX's model at float64 on the
    same weights and batch (its head casts the logits to f32, and its loss
    takes its sums in f32), named as the port's parameters."""
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa
        params, stats = f64(jax_vars["params"]), f64(jax_vars["batch_stats"])
        model = JaxSegAE(num_classes=4, base=BASE, dtype=jnp.float64)

        def loss(p):
            out, _ = model.apply({"params": p, "batch_stats": stats}, jnp.asarray(x, jnp.float64),
                                 train=True, mutable=["batch_stats"])
            return JaxDiceCE(**loss_kw)(out, jnp.asarray(y))

        grads = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params))
    return from_jax_variables({"params": grads, "batch_stats": jax_vars["batch_stats"]})


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_frozen_encoder_steps_and_decoder_gradients(transferred, recon_init):
    """Two frozen steps: encoder parameters unchanged, its BN running
    statistics moved (train mode, as JAX's mutable batch_stats). The first
    step's decoder gradients against jax.grad of JAX's step loss on the
    same grafted weights, taken in float64 (f32 logits and loss sums),
    within 1e-4 in relative L2 each (5.2e-5 at most seen). Through the deeper decoder blocks the
    train-mode BN backward sums cancel: JAX's own f32 gradients sit 1-2%
    from its float64 ones there, so they are no reference at 1e-4."""
    _, seg, seg_init, _ = transferred
    loss_kw = dict(class_weights=C.FULL_WEIGHTS, smooth_dice=1.0)
    # JAX's graft of the same recon encoder (load_subtree_variables with
    # prefix "encoder"): the port's grafted model is its conversion
    jax_vars = {part: {**seg_init[part], "encoder": recon_init[part]["encoder"]}
                for part in ("params", "batch_stats")}
    want_sd = from_jax_variables(jax_vars)
    assert all(torch.equal(v, want_sd[k]) for k, v in seg.state_dict().items())

    x, y = _seg_batch()
    want = _jax_f64_grads(jax_vars, x, y, loss_kw)
    mask = subtree_mask(jax_vars["params"], ("encoder",))
    assert not any(jax.tree_util.tree_leaves(mask["encoder"]))

    freeze_(seg, ("encoder",))
    opt, _ = C.build_optimizer(C.AUTOENCODER, seg, frozen_prefixes=("encoder",))
    st = TrainState(seg, opt)
    seg.train()
    before = {k: v.clone() for k, v in seg.state_dict().items()}
    grads = {}
    orig_step = opt.step

    def spy_step(*a, **k):  # the gradients as the optimizer sees them
        if not grads:
            grads.update({n: p.grad.clone() for n, p in seg.named_parameters()
                          if p.grad is not None})
        return orig_step(*a, **k)

    opt.step = spy_step
    for _ in range(2):
        train_step(st, DiceCELoss(**loss_kw), torch.from_numpy(x), torch.from_numpy(y).long())
    after = seg.state_dict()
    for k, v in before.items():
        if k.startswith("encoder."):
            assert torch.equal(after[k], v) != ("running" in k), k
        elif "running" not in k:
            assert not torch.equal(after[k], v), k  # the decoder trains
    assert grads and not any(n.startswith("encoder.") for n in grads)
    assert len(grads) == sum(not n.startswith("encoder.") for n, _ in seg.named_parameters())
    for n, g in grads.items():
        err = _rel(g.numpy().astype(np.float64), want[n].numpy().astype(np.float64))
        assert err <= 1e-4, (n, err)
