"""Prompt-model training in the port against the JAX package: the triplet
generator and the prompt relabelling (bit for bit), one heatmap train
step of the `prompt` config (freeze_clip False: the clip decoder and the
selection UNet train, the ViT stays frozen) against `jax.grad`, the
frozen ViT through AdamW steps, and the heatmaps' uint8 residency past
the device budget. Widths: run.py's `--smoke-vit` (ViT hidden 64, 4
layers, 4 heads, MLP 128; skips (1, 2, 3, 4); decoder (64, 32, 16, 8, 8);
selection UNet base 8) at 64 px, f32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from image_segmentation_tpu.data.labels import remap_for_prompt_task as jax_remap
from image_segmentation_tpu.data.prompts import generate_prompt_dataset as jax_generate
from image_segmentation_tpu.losses import DiceNLLLoss as JaxDiceNLL
from image_segmentation_tpu.models.clip_vit import ClipViTConfig as JaxViTConfig
from image_segmentation_tpu.models.prompt import PromptModel as JaxPromptModel
from image_segmentation_tpu.train import loop as jax_loop
from image_segmentation_tpu.train.state import subtree_mask
from image_segmentation_tpu_torch import config as C
from image_segmentation_tpu_torch.data.dataset import ArrayDataset
from image_segmentation_tpu_torch.data.labels import remap_for_prompt_task
from image_segmentation_tpu_torch.data.loader import materialize
from image_segmentation_tpu_torch.data.prompts import generate_prompt_dataset
from image_segmentation_tpu_torch.losses import DiceNLLLoss
from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.prompt import PromptModel
from image_segmentation_tpu_torch.run import _synthetic_items
from image_segmentation_tpu_torch.train import loop
from image_segmentation_tpu_torch.train.state import TrainState, freeze_
from image_segmentation_tpu_torch.train.steps import train_step

torch.set_num_threads(1)

SIDE = 64
VIT = dict(image_size=SIDE, patch_size=16, hidden_size=64, num_layers=4, num_heads=4,
           mlp_dim=128)
CLIP = dict(skip_indices=(1, 2, 3, 4), decoder_channels=(64, 32, 16, 8, 8))
FROZEN = ("clip.vision_model",)


def _raw_items(n, seed):
    """run.py's synthetic items at a quarter size (raw 255 boundaries),
    and one all-background item, which has one target class and is
    skipped."""
    items = [(img[::4, ::4].copy(), lab[::4, ::4].copy()) for img, lab in
             _synthetic_items(n, seed)]
    return items + [(items[0][0], np.zeros_like(items[0][1]))]


@pytest.mark.parametrize("seed", [0, 1])
def test_prompt_triplets_equal_jax_bit_for_bit(seed):
    items = _raw_items(6, seed)
    got = generate_prompt_dataset(ArrayDataset(items), seed=seed)
    want = jax_generate(JaxArrayDataset(items), seed=seed)
    assert len(got) == len(want) == 12  # two a sample; the background one skipped
    for g, w in zip(got.items, want.items):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
def test_remap_for_prompt_task_equals_jax(dtype):
    label = np.random.default_rng(0).choice(np.array([0, 1, 2, 255]), (16, 16)).astype(dtype)
    got, want = remap_for_prompt_task(label), jax_remap(label)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {1, 2, 3}


def _jax_prompt(seed):
    model = JaxPromptModel(vit=JaxViTConfig(**VIT), unet_base=8, freeze_clip=False, **CLIP)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, SIDE, SIDE, 3)),
                   jnp.zeros((1, SIDE, SIDE, 1)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)
    return model, {"params": jax.tree_util.tree_map(
                       lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
                       v["params"]),
                   "batch_stats": jax.tree_util.tree_map(
                       lambda a: (a + rng.uniform(0.0, 0.5, a.shape)).astype(np.float32),
                       v["batch_stats"])}


def _port_prompt(variables):
    """The prompt config's model as run.py trains it: freeze_clip False,
    the ViT frozen out of AdamW."""
    port = PromptModel(vit=ClipViTConfig(**VIT), unet_base=8, freeze_clip=False, **CLIP)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    port = port.to(memory_format=torch.channels_last)
    freeze_(port, FROZEN)
    return port, TrainState(port, *C.build_optimizer(C.PROMPT, port, frozen_prefixes=FROZEN))


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, SIDE, SIDE, 3)).astype(np.float32)
    hm = rng.uniform(0, 1, (n, SIDE, SIDE, 1)).astype(np.float32)
    y = rng.integers(0, 4, (n, SIDE, SIDE)).astype(np.int32)
    return x, hm, y


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_f64_step(v, x, hm, y):
    """JAX's prompt step in float64 (JAX's model at float64, `jax.enable_x64`):
    the loss and the gradient of micro 2 x accum 2, the second micro-batch
    on the statistics the first left, as JAX's scan runs them; the
    gradients named as the port's parameters."""
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa
        m64 = JaxPromptModel(vit=JaxViTConfig(**VIT), unet_base=8, freeze_clip=False,
                             dtype=jnp.float64, **CLIP)

        def micro_loss(p, rows, bs):
            out, mut = m64.apply({"params": p, "batch_stats": bs},
                                 jnp.asarray(x[rows], jnp.float64),
                                 jnp.asarray(hm[rows], jnp.float64), train=True,
                                 mutable=["batch_stats"])
            return JaxDiceNLL(smooth_dice=1.0)(out, jnp.asarray(y[rows])), mut["batch_stats"]

        grad = jax.value_and_grad(micro_loss, has_aux=True)
        params = f64(v["params"])
        (l1, bs1), g1 = grad(params, slice(0, 2), f64(v["batch_stats"]))
        (l2, _), g2 = grad(params, slice(2, 4), bs1)
        jgrad = jax.tree_util.tree_map(lambda a, b: np.asarray((a + b) / 2), g1, g2)
        loss = float((l1 + l2) / 2)
    assert all(not np.any(g) for g in jax.tree_util.tree_leaves(jgrad["clip"]["encoder"]))
    return loss, {k: t.numpy().astype(np.float64) for k, t in from_jax_variables(
        {"params": jgrad, "batch_stats": v["batch_stats"]}).items()}


def _port_step_grads(v, x, hm, y, dtype):
    """The port's prompt step (micro 2 x accum 2) in `dtype`: its loss and
    the gradients the optimizer is given."""
    port = PromptModel(vit=ClipViTConfig(**VIT), unet_base=8, freeze_clip=False, dtype=dtype,
                       **CLIP)
    port.load_state_dict(from_jax_variables(v), strict=True)
    port = port.to(dtype=dtype, memory_format=torch.channels_last)
    freeze_(port, FROZEN)
    st = TrainState(port, *C.build_optimizer(C.PROMPT, port, frozen_prefixes=FROZEN))
    grads, step = {}, st.optimizer.step

    def spy(*a, **k):
        grads.update({n: p.grad.double().numpy() for n, p in port.named_parameters()
                      if p.grad is not None})
        return step(*a, **k)

    st.optimizer.step = spy
    cast = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    loss = train_step(st, C.build_loss(C.PROMPT), (cast(x), cast(hm)),
                      torch.from_numpy(y).long(), 2)
    assert len(grads) == sum(not n.startswith(FROZEN[0] + ".")
                             for n, _ in port.named_parameters())
    return float(loss), grads


# The conv biases that feed a train-mode BatchNorm have exact gradient 0;
# both sides' are rounding noise.
BN_FED = ("conv1.conv.bias", "conv2.conv.bias")


def test_prompt_step_matches_jax_grad():
    """One `train_step` of the prompt config on (images, heatmaps), micro 2
    x accum 2, Dice + NLL with the train smooth 1 and uniform class
    weights, against jax.grad of JAX's PromptModel(freeze_clip=False) step
    on the same weights and batch taken in float64. No clip.vision_model
    parameter gets a .grad (JAX's gradient there is 0). The loss is within
    1e-5 of JAX's (both packages take the loss's sums in f32). The port's
    own step in float64 holds every gradient within 1e-5 relative L2 (its
    frozen ViT keeps f32 LayerNorms and the loss f32 sums): the same math.
    Its f32 step holds the clip decoder's gradients within
    1e-4 and the selection UNet's within 1e-2: torch's f32 BatchNorm
    backward on the CPU cancels in that UNet on these inputs, 0.08-0.7%
    from float64 (JAX's f32 step lies within 6e-5 there; in the
    autoencoder's decoder, tests/test_torch_recon.py, the sides were the
    other way round)."""
    model, v = _jax_prompt(3)
    x, hm, y = _batch(4, 3)
    loss_cfg = C.build_loss(C.PROMPT)
    assert isinstance(loss_cfg, DiceNLLLoss) and loss_cfg.class_weights is None
    jloss, want = _jax_f64_step(v, x, hm, y)
    for dtype, tol_clip, tol_mask in ((torch.float64, 1e-5, 1e-5),
                                      (torch.float32, 1e-4, 1e-2)):
        loss, grads = _port_step_grads(v, x, hm, y, dtype)
        assert abs(loss - jloss) <= 1e-5, (dtype, loss, jloss)
        for n, g in grads.items():
            if n.startswith("mask.") and n.endswith(BN_FED):
                assert np.abs(g).max() <= 1e-6 and np.abs(want[n]).max() <= 1e-6, n
                continue
            tol = tol_mask if n.startswith("mask.") else tol_clip
            assert _rel(g, want[n]) <= tol, (dtype, n, _rel(g, want[n]))


def test_vision_model_unchanged_by_steps():
    """Three AdamW steps (weight decay 0.01) of the prompt config: every
    clip.vision_model parameter is unchanged, bit for bit, as JAX masks
    `clip/encoder` out of its optimizer (`subtree_mask`), while the clip
    decoder and the selection UNet move."""
    _, v = _jax_prompt(4)
    mask = subtree_mask(v["params"], ("clip/encoder",))
    assert not any(jax.tree_util.tree_leaves(mask["clip"]["encoder"]))
    assert all(jax.tree_util.tree_leaves(mask["mask"]))
    port, st = _port_prompt(v)
    before = {k: t.clone() for k, t in port.state_dict().items()}
    x, hm, y = _batch(2, 4)
    for _ in range(3):
        train_step(st, C.build_loss(C.PROMPT), (torch.from_numpy(x), torch.from_numpy(hm)),
                   torch.from_numpy(y).long())
    after = port.state_dict()
    for k, t in before.items():
        if k.startswith(FROZEN[0] + "."):
            assert torch.equal(after[k], t), k
        elif k.endswith("weight") and ".bn." not in k:
            assert not torch.equal(after[k], t), k


def test_heatmaps_resident_as_uint8_past_the_budget(monkeypatch, tmp_path):
    """A prompt train set whose float32 images, heatmaps and labels exceed
    the budget while a quarter fits: `fit` holds the images and heatmaps as
    uint8 (JAX's `_quantize_u8` bytes, bit for bit; JAX's plan makes the same
    choice) and the labels as uint8, and gathers ((images, heatmaps),
    labels) batches decoded to [0, 1]. The fit trains to a finite loss."""
    triplets = generate_prompt_dataset(ArrayDataset(_raw_items(4, 5)), seed=5)
    data = materialize(triplets, SIDE)
    val = materialize(triplets, SIDE, keep_orig_labels=True)
    nbytes = data.images.nbytes + data.heatmaps.nbytes + data.labels.nbytes
    budget_mb = nbytes / 2 / 2**20
    monkeypatch.setenv(loop.BUDGET_ENV, str(budget_mb))
    assert jax_loop._resident_plan("auto", nbytes, int(budget_mb * 2**20)) == (True, True)

    model = C.build_model(C.PROMPT, "cpu", torch.Generator().manual_seed(0),
                          vit=ClipViTConfig(**VIT), unet_base=8, **CLIP)
    freeze_(model, FROZEN)
    st = TrainState(model, *C.build_optimizer(C.PROMPT, model, frozen_prefixes=FROZEN))
    res = loop.fit(st, data, val, loss_fn=C.build_loss(C.PROMPT), epochs=1, batch_size=4,
                   accum_steps=2, save_dir=str(tmp_path), name="prompt", verbose=False)
    assert np.isfinite(res.history["train_loss"][0])
    resident = data.device_train_cache[1]
    assert resident.quantize and resident.heatmaps.dtype == torch.uint8
    np.testing.assert_array_equal(resident.heatmaps.numpy(), jax_loop._quantize_u8(data.heatmaps))
    np.testing.assert_array_equal(resident.images.numpy(), jax_loop._quantize_u8(data.images))
    (xb, hb), yb = resident.batch(torch.arange(3))
    np.testing.assert_array_equal(hb.numpy(), jax_loop._quantize_u8(data.heatmaps[:3])
                                  .astype(np.float32) * np.float32(1 / 255))
    assert xb.dtype == hb.dtype == torch.float32 and yb.dtype == torch.int64
    assert torch.equal(yb, torch.from_numpy(data.labels[:3]).long())
