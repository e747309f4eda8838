"""The port's prompt model and composed prompt serving, held against the
JAX package with the same weights (`from_jax_variables`) and the same
seeded numpy inputs, at the JAX demo's widths (ViT hidden 64, 4 heads,
MLP 128, 3 blocks at 64 px; decoder (64, 32, 16, 8, 8); selection UNet
base 8), f32 on the CPU. Also: the converter's dispatch on every tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.models import SegmentationAutoencoder as JaxAE
from image_segmentation_tpu.models import UNet as JaxUNet
from image_segmentation_tpu.models.clip_unet import ClipUNet as JaxClipUNet
from image_segmentation_tpu.models.clip_vit import ClipViTConfig as JaxViTConfig
from image_segmentation_tpu.models.prompt import PromptModel as JaxPromptModel
from image_segmentation_tpu.ops import geometry as JG
from image_segmentation_tpu.serve import engine as jax_engine
from image_segmentation_tpu_torch.models.autoencoder import SegmentationAutoencoder
from image_segmentation_tpu_torch.models.clip_unet import ClipUNet
from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.prompt import PromptModel
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.serve import engine as port_engine
from image_segmentation_tpu_torch.serve.render import render_points

torch.set_num_threads(1)

VIT = dict(image_size=64, patch_size=16, hidden_size=64, num_layers=3, num_heads=4, mlp_dim=128)
CLIP = dict(skip_indices=(0, 1, 2, 3), decoder_channels=(64, 32, 16, 8, 8))
# f32 on both sides; probabilities in [0, 1] after a ViT, a decoder and a
# ten-level UNet: the same sums in another order. Largest seen ~1e-6.
ATOL = 2e-5


def _perturbed(v, seed):
    """Parameters moved off their init and BN statistics off 0 and 1."""
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)
    return {"params": jax.tree_util.tree_map(
                lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), v["params"]),
            "batch_stats": jax.tree_util.tree_map(
                lambda a: (a + rng.uniform(0.0, 0.5, a.shape)).astype(np.float32),
                v["batch_stats"])}


@pytest.fixture(scope="module")
def prompt_weights():
    """A JAX PromptModel at the demo widths (f32, as the JAX demo registry
    builds it) and the port's carrying the same weights."""
    model = JaxPromptModel(vit=JaxViTConfig(**VIT), unet_base=8, **CLIP)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 1)))
    v = _perturbed(v, 0)
    port = PromptModel(vit=ClipViTConfig(**VIT), unet_base=8, **CLIP)
    port.load_state_dict(from_jax_variables(v), strict=True)
    return model, v, port.to(memory_format=torch.channels_last).eval()


def _inputs(n=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 64, 64, 3)).astype(np.float32)
    hm = np.stack([render_points([{"x": 20 + 10 * i, "y": 30}], (64, 64)) for i in range(n)])
    return x, hm[..., None]


def test_prompt_model_forward_matches_jax(prompt_weights):
    """Probabilities (N, 64, 64, 4) f32 against the JAX eval forward, atol 2e-5."""
    model, v, port = prompt_weights
    x, hm = _inputs()
    want = np.asarray(model.apply(v, jnp.asarray(x), jnp.asarray(hm), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(hm))
    assert got.shape == want.shape == (2, 64, 64, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)  # a distribution


@pytest.mark.parametrize("use_kernels", [False, True])
def test_selection_unet_four_channels_in_matches_jax(use_kernels):
    """UNet(in_channels=4, num_classes=1), the prompt model's selection
    network: module path and K1 path (plain K1 on the CPU, the stem padded
    to 8 channels on a card) against JAX's UNet, which infers the input
    width; f32 logits, atol 2e-5."""
    model = JaxUNet(num_classes=1, base=8)
    v = _perturbed(model.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 4))), 1)
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 4)).astype(np.float32)
    want = np.asarray(model.apply(v, jnp.asarray(x), train=False))
    port = UNet(num_classes=1, base=8, in_channels=4, use_kernels=use_kernels)
    port.load_state_dict(from_jax_variables(v), strict=True)
    with torch.no_grad():
        got = port.to(memory_format=torch.channels_last).eval()(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_composed_equals_monolithic_in_the_port(prompt_weights):
    """The composed entry (clip branch cached, head per request) gives
    exactly the monolithic forward's scores, on a miss and on a hit."""
    _, _, port = prompt_weights
    eng = port_engine.InferenceEngine(device="cpu", fast_transfer=False)
    eng.register_prompt_composed("comp", port, 64)
    x, hm = _inputs(n=1, seed=3)
    with torch.inference_mode():
        mono = port(torch.from_numpy(x), torch.from_numpy(hm)).numpy()
    np.testing.assert_array_equal(eng.forward("comp", x, hm), mono)
    np.testing.assert_array_equal(eng.forward("comp", x, hm), mono)
    cache = eng.models["comp"].score_cache
    assert (cache.misses, cache.hits) == (1, 1)


def _jax_engines(model, v, fast_transfer):
    """The JAX engine's composed prompt family (riding a clip family that
    carries the prompt model's clip weights) and its monolithic one."""
    clip_v = {"params": v["params"]["clip"], "batch_stats": v["batch_stats"]["clip"]}
    comp = jax_engine.InferenceEngine(fast_transfer=fast_transfer)
    comp.register("clip", JaxClipUNet(vit=JaxViTConfig(**VIT), **CLIP), clip_v, 64)
    comp.register_prompt_composed("prompt_model", model, v, via="clip", target_size=64)
    assert comp.models["prompt_model"].score_cache is not None
    mono = jax_engine.InferenceEngine(fast_transfer=fast_transfer)
    mono.register("prompt_model", model, v, 64, needs_prompt=True)
    return comp, mono


def _jax_scores(eng, img, hm, fast_transfer):
    entry = eng.models["prompt_model"]
    inputs, meta = jax_engine.stage_request(img, entry, hm, fast_transfer)
    return np.asarray(entry.forward(*[a[None] for a in inputs]), np.float32)[0], meta


@pytest.mark.parametrize("hw", [(48, 72), (400, 1)])
def test_engine_matches_jax_composed_prompt_family(prompt_weights, hw):
    """float32 transfer: the port's composed engine and the JAX engine's
    composed family give the same masks, except at near-ties (a top-two
    gap below 1e-4 in the JAX engine's restored scores)."""
    model, v, port = prompt_weights
    comp, _ = _jax_engines(model, v, fast_transfer=False)
    p_eng = port_engine.InferenceEngine(device="cpu", fast_transfer=False)
    p_eng.register_prompt_composed("prompt_model", port, 64)
    img = np.random.default_rng(sum(hw)).uniform(0, 1, hw + (3,)).astype(np.float32)
    hm = render_points([{"x": hw[1] // 2, "y": hw[0] // 2}], hw)

    got = p_eng.segment(img, "prompt_model", hm)
    want = comp.segment(img, "prompt_model", prompt_mask=hm)
    assert got["mask"].shape == hw and got["class_names"] == want["class_names"]
    scores, meta = _jax_scores(comp, img, hm, False)
    restored = np.sort(JG.invert_resize_padding_np(scores, meta), axis=-1)
    near_tie = restored[..., -1] - restored[..., -2] < 1e-4
    assert not np.any((got["mask"] != want["mask"]) & ~near_tie)


def test_fast_transfer_composed_softmaxes_f32_logits(prompt_weights):
    """bf16 transfer. The JAX composed family softmaxes the bf16-cast
    transfer scores of the clip program (engine.py:142), its monolithic
    family the f32 logits. The port's composed path caches f32 logits, as
    the monolithic path intends: its scores are within one bf16 step of
    probabilities (2^-8) of the JAX monolithic family's, while the JAX
    composed family's lie further from it."""
    model, v, port = prompt_weights
    comp, mono = _jax_engines(model, v, fast_transfer=True)
    p_eng = port_engine.InferenceEngine(device="cpu", fast_transfer=True)
    p_eng.register_prompt_composed("prompt_model", port, 64)
    img = np.random.default_rng(5).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    hm = render_points([{"x": 30, "y": 30}], (64, 64))

    want, _ = _jax_scores(mono, img, hm, True)
    jax_comp, _ = _jax_scores(comp, img, hm, True)
    entry = p_eng.models["prompt_model"]
    inputs, _ = port_engine.stage_request(img, entry, hm, True)
    got = p_eng.forward("prompt_model", *(a[None] for a in inputs))[0]
    port_err = np.abs(got - want).max()
    jax_err = np.abs(jax_comp - want).max()
    print(f"max |scores - JAX monolithic|: port composed {port_err}, JAX composed {jax_err}")
    assert port_err <= 2.0**-8
    assert jax_err > port_err


def test_score_cache_counts_hits_over_three_clicks(prompt_weights):
    """tests/test_serve.py:112-136 for the port: three clicks on one image
    run the clip branch once (1 miss, 2 hits); another image misses."""
    _, _, port = prompt_weights
    eng = port_engine.InferenceEngine(device="cpu")
    eng.register_prompt_composed("prompt_model", port, 64)
    cache = eng.models["prompt_model"].score_cache
    img = np.random.default_rng(1).uniform(0, 1, (60, 60, 3)).astype(np.float32)
    outs = [eng.segment(img, "prompt_model", render_points([{"x": x, "y": 30}], (60, 60)))
            for x in (10, 30, 50)]
    assert (cache.misses, cache.hits) == (1, 2)
    assert all(o["mask"].shape == (60, 60) and o["mask"].max() <= 3 for o in outs)
    assert outs[0]["class_names"] == ["deactivated", "background", "cat", "dog"]
    eng.segment(img[::-1], "prompt_model")
    assert (cache.misses, cache.hits) == (2, 2)


def test_score_cache_is_lru():
    cache = port_engine._ScoreCache(capacity=2)
    keys = [port_engine._ScoreCache.key(np.full((2, 2), i, np.uint8)) for i in range(3)]
    for i, k in enumerate(keys):
        cache.put(k, torch.tensor(float(i)))
    assert cache.get(keys[0]) is None and cache.get(keys[2]).item() == 2.0
    assert (cache.misses, cache.hits) == (1, 1)


def _jax_tree(kind):
    key, vit = jax.random.PRNGKey(0), JaxViTConfig(**VIT)
    x, hm = jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 1))
    if kind == "unet":
        return UNet(base=8), JaxUNet(num_classes=4, base=8).init(key, x)
    if kind == "autoencoder":
        return SegmentationAutoencoder(base=8), JaxAE(num_classes=4, base=8).init(key, x)
    if kind == "clip":
        return (ClipUNet(vit=ClipViTConfig(**VIT), **CLIP),
                JaxClipUNet(vit=vit, **CLIP).init(key, x))
    return (PromptModel(vit=ClipViTConfig(**VIT), unet_base=8, **CLIP),
            JaxPromptModel(vit=vit, unet_base=8, **CLIP).init(key, x, hm))


@pytest.mark.parametrize("kind", ["unet", "autoencoder", "clip", "prompt"])
def test_convert_dispatches_on_what_the_tree_is(kind):
    """Each family's JAX tree converts to exactly its port module's
    state_dict (strict=True): a ClipUNet is told by encoder/class_embedding,
    an autoencoder by encoder/EncoderBlock_0, a prompt model by clip and
    mask. Converted values are the JAX ones."""
    port, v = _jax_tree(kind)
    sd = from_jax_variables(jax.tree_util.tree_map(np.asarray, v))
    port.load_state_dict(sd, strict=True)
    leaves = jax.tree_util.tree_leaves(v)
    assert len(sd) == len(leaves)
    assert sum(t.numel() for t in sd.values()) == sum(a.size for a in leaves)


def test_convert_refuses_an_unknown_tree():
    with pytest.raises(ValueError, match="unknown JAX variables tree"):
        from_jax_variables({"params": {"Dense_0": {"kernel": np.zeros((2, 2))}}})
    with pytest.raises(ValueError, match="unknown JAX variables tree"):
        from_jax_variables({"params": {"encoder": {"Dense_0": {}}}})


class _Joined(torch.nn.Module):
    """The prompt model as a one-input module, for `train_step`: image and
    heatmap concatenated along channels."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, xh):
        return self.model(xh[..., :3], xh[..., 3:])


def test_frozen_prompt_model_train_step_matches_jax_grad():
    """One `train_step` of PromptModel(freeze_clip=True), the default, in
    train mode on the CPU: no parameter of the clip branch gets a .grad,
    and every parameter of the `mask` selection UNet gets the gradient of
    jax.grad of the JAX PromptModel (freeze_clip=True) on the same weights
    and batch, Dice + NLL on the probabilities. Both run the clip branch
    with batch statistics (JAX passes `train` to it), so the mask gradient
    sees the same clip probabilities. f32; relative L2 error per tensor
    ≤ 1e-4, but:
      * ≤ 2e-2 in the two shallowest levels (down1, down2), where JAX's own
        f32 gradient lies 0.5-0.9% from its f64 gradient (flax's BatchNorm
        backward cancels there, on these inputs), while the port's f32
        gradient lies within 3e-5 of its own f64 one;
      * the conv biases that feed a train-mode BatchNorm have exact
        gradient 0: both sides' are rounding noise below 1e-6."""
    from image_segmentation_tpu.losses import DiceNLLLoss as JaxDiceNLL
    from image_segmentation_tpu_torch.losses import DiceNLLLoss
    from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
    from image_segmentation_tpu_torch.train.steps import train_step

    model = JaxPromptModel(vit=JaxViTConfig(**VIT), unet_base=8, **CLIP)
    v = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 1)))
    v = _perturbed(v, 2)
    x, hm = _inputs(seed=4)
    y = np.random.default_rng(4).integers(0, 4, (2, 64, 64)).astype(np.int32)

    def loss(params):
        out, _ = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                             jnp.asarray(x), jnp.asarray(hm), train=True,
                             mutable=["batch_stats"])
        return JaxDiceNLL(smooth_dice=1.0)(out, jnp.asarray(y))

    jgrad = jax.grad(loss)(v["params"])
    assert all(not np.any(np.asarray(g)) for g in jax.tree_util.tree_leaves(jgrad["clip"]))
    want = {k: t.numpy() for k, t in from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jgrad),
         "batch_stats": v["batch_stats"]}).items()}

    port = PromptModel(vit=ClipViTConfig(**VIT), unet_base=8, **CLIP)
    assert port.freeze_clip and port.clip.freeze_encoder
    port.load_state_dict(from_jax_variables(v), strict=True)
    port = port.to(memory_format=torch.channels_last)
    joined = _Joined(port)
    st = TrainState(joined, *make_adamw(joined.parameters(), learning_rate=1e-3))
    xh = torch.from_numpy(np.concatenate([x, hm], axis=-1))
    train_step(st, DiceNLLLoss(smooth_dice=1.0), xh, torch.from_numpy(y).long())
    mask = 0
    for name, p in port.named_parameters():
        if name.startswith("clip."):
            assert p.grad is None, name
            continue
        mask += 1
        g = p.grad.numpy()
        if name.endswith(("conv1.conv.bias", "conv2.conv.bias")):
            assert np.abs(g).max() <= 1e-6 and np.abs(want[name]).max() <= 1e-6, name
            continue
        rel = float(np.linalg.norm(g - want[name]) / np.linalg.norm(want[name]))
        tol = 2e-2 if name.startswith(("mask.down1.", "mask.down2.")) else 1e-4
        assert rel <= tol, (name, rel)
    assert mask == sum(1 for k in want if k.startswith("mask.") and "running" not in k)
