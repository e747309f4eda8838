"""The port's speed probes (`image_segmentation_tpu_torch/probes/`) against
the JAX repository's benchmarks and the JAX package, at the JAX probes'
CPU sizes.

* confusion_probe: the port's bincount, one-hot product and scatter-add
  counts and JAX's `confusion_counts_masked` are equal integers on the
  same canvases with 15% FILL.
* eval_bench: `_SyntheticPet` makes JAX's arrays; the bucket plan summary
  is JAX's; with JAX's PRNGKey(0) UNet carried across, the port's device
  and host protocols give JAX's `evaluate` dice, mIoU and val loss within
  1e-4.
* step_variants: fusedloss is base's loss (1e-6 relative) and JAX's
  DiceCELoss(ignore_index=3) (1e-5); dts's up conv is the transpose conv
  (1e-5); remat's gradients are base's (1e-5) and its running statistics
  after a step equal base's.
* profile_train_step prints JAX's keys, and its `step` is `train_step`.
* backward_anatomy on a base-8 UNet (CPU ops stand in for kernels): every
  bucket is there and the shares sum to 1; each conv's GFLOP is a hand
  count; the layer a backward node gets from its sequence number is the
  one that module backward hooks give.
* reference_recipe / reference_anchor: the port's RefUNet holds JAX's
  `_build_ref_unet()` state dict and gives its outputs; one torch-samechip
  window of 4 micro-batches leaves train_step(accum_steps=4)'s parameters.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from image_segmentation_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from image_segmentation_tpu.data.loader import materialize as jax_materialize
from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
from image_segmentation_tpu.metrics.confusion import confusion_counts_masked
from image_segmentation_tpu.models import UNet as JaxUNet
from image_segmentation_tpu.ops import geometry as jax_geometry
from image_segmentation_tpu.train import create_train_state
from image_segmentation_tpu.train import fast_eval as jax_fast_eval
from image_segmentation_tpu.train.loop import evaluate as jax_evaluate
from image_segmentation_tpu.train.state import make_adamw as jax_adamw
from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.layers import UpConv
from image_segmentation_tpu_torch.ops import geometry as port_geometry
from image_segmentation_tpu_torch.probes import (
    backward_anatomy,
    confusion_probe,
    eval_bench,
    production_step,
    profile_train_step,
    reference_anchor,
    reference_recipe,
    step_variants,
)
from image_segmentation_tpu_torch.train import fast_eval
from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
from image_segmentation_tpu_torch.train.steps import train_step
from test_torch_study_prepare import load_jax_file

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_eval_bench():
    return load_jax_file("benchmarks/eval_bench.py", "jax_eval_bench")


# -- confusion_probe ------------------------------------------------------

@pytest.mark.parametrize("seed,classes", [(0, 4), (1, 4), (2, 3)])
def test_confusion_formulations_equal_jax(seed, classes):
    labels, preds, valid = confusion_probe.inputs(4, 64, classes, "cpu", seed=seed)
    assert abs(float((~valid).float().mean()) - confusion_probe.FILL_SHARE) < 0.02
    want = np.asarray(confusion_counts_masked(
        jnp.asarray(preds.numpy()), jnp.asarray(labels.numpy()), jnp.asarray(valid.numpy()),
        classes)).astype(np.int64)
    assert want.sum() == int(valid.sum())
    for name, fn in confusion_probe.FORMULATIONS.items():
        got = fn(labels, preds, valid, classes)
        assert got.dtype == torch.int64, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_confusion_probe_main_on_the_cpu(capsys):
    out = confusion_probe.main(["--device", "cpu", "--iters", "2", "--repeat", "2"])
    assert out["counts_equal"] and out["summary"] == "confusion_probe"
    assert [r["metric"] for r in out["rows"]] == [
        f"confusion_{n}_ms_per_dispatch" for n in ("bincount", "matmul", "scatter")]
    assert all(r["shape"] == [4, 64, 64] and r["card"] is None for r in out["rows"])
    assert len(capsys.readouterr().out.splitlines()) == 4


# -- eval_bench ------------------------------------------------------------

@pytest.mark.parametrize("pet_like", [False, True])
def test_synthetic_pet_equals_jax(jax_eval_bench, pet_like):
    got = eval_bench._SyntheticPet(12, seed=3, pet_like=pet_like)
    want = jax_eval_bench._SyntheticPet(12, seed=3, pet_like=pet_like)
    assert got.sizes == want.sizes
    for i in (0, 11):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_bucket_plan_summary_equals_jax(jax_eval_bench):
    class _Set:
        def __init__(self, labels, views=None):
            self.orig_labels, self.bucket_views = labels, views

        def __len__(self):
            return len(self.orig_labels)

    ds = eval_bench._SyntheticPet(120, seed=0, pet_like=True)
    labels = [np.zeros(hw, np.uint8) for hw in ds.sizes]
    plans = {"port": fast_eval.plan_size_buckets(labels),
             "jax": jax_fast_eval.plan_size_buckets(labels)}
    assert len(plans["port"]) > 1
    summary = {}
    for side, fn in (("port", eval_bench._bucket_plan_summary),
                     ("jax", jax_eval_bench._bucket_plan_summary)):
        views = [_Set([labels[i] for i in idx]) for idx in plans[side]]
        summary[side] = fn(_Set(labels, views))
    assert summary["port"] == summary["jax"]
    assert sum(b["images"] for b in summary["port"]) == 120
    # one canvas ([] views) is the whole set's
    assert eval_bench._bucket_plan_summary(_Set(labels[:4], [])) == \
        jax_eval_bench._bucket_plan_summary(_Set(labels[:4], []))


def test_eval_protocols_equal_jax_evaluate(monkeypatch):
    monkeypatch.setattr(jax_geometry, "_native", lambda: None)
    monkeypatch.setattr(port_geometry, "_native", lambda: None)
    val, state, _ = eval_bench.setup(8, False, "cpu")
    sz = eval_bench.sizes("cpu")
    ds = eval_bench._SyntheticPet(8, max_side=sz["max_side"], min_side=sz["min_side"])
    jval = jax_materialize(JaxArrayDataset([ds[i] for i in range(8)]), sz["target"],
                           keep_orig_labels=True)
    np.testing.assert_array_equal(val.images, np.asarray(jval.images))
    jstate = create_train_state(JaxUNet(num_classes=4, base=8, dtype=jnp.float32),
                                jax.random.PRNGKey(0), jnp.asarray(jval.images[:1]),
                                jax_adamw(learning_rate=1e-3))
    state.model.load_state_dict(from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, jstate.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, jstate.batch_stats)}))
    want = jax_evaluate(jstate, jval, num_classes=4, batch_size=16, verbose=False,
                        protocol="device", loss_cfg=JaxDiceCE(ignore_index=3))
    rows, metrics = eval_bench.measure(state, val, ["device", "host"], 16)
    for protocol, got in metrics.items():
        for k in ("dice", "iou", "loss"):
            assert abs(float(got[k]) - float(want[k])) < 1e-4, (protocol, k)
    assert [r["metric"] for r in rows] == ["orig_res_eval_images_per_sec_device",
                                           "orig_res_eval_images_per_sec_host"]
    assert eval_bench.summarize(metrics)["metrics_match_host_oracle"]


def test_eval_bench_main_prints_jax_keys(capsys, tmp_path):
    out = eval_bench.main(["--device", "cpu", "--out", str(tmp_path / "e.json")])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert {"metric", "value", "unit", "images", "dice", "miou", "val_loss",
            "bucket_plan"} <= set(lines[0])
    assert {"staging_s", "pet_like", "metrics_bit_identical", "dice_delta", "miou_delta",
            "loss_delta", "metrics_match_host_oracle"} <= set(lines[-1])
    assert out["metrics_match_host_oracle"] and out["rows"][0]["images"] == 8
    assert json.loads((tmp_path / "e.json").read_text())["rows"] == out["rows"]


# -- step_variants ---------------------------------------------------------

@pytest.fixture(scope="module")
def step_inputs():
    return production_step("cpu")


def test_fusedloss_equals_base_and_jax_loss():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (3, 16, 16, 4)).astype(np.float32)
    targets = rng.integers(0, 4, (3, 16, 16))
    lg, tg = torch.from_numpy(logits), torch.from_numpy(targets)
    fused = float(step_variants.FusedDiceCE()(lg, tg))
    base = float(DiceCELoss(ignore_index=3)(lg, tg))
    jax_loss = float(JaxDiceCE(ignore_index=3)(jnp.asarray(logits), jnp.asarray(targets)))
    assert abs(fused - base) <= 1e-6 * abs(base)
    assert abs(fused - jax_loss) <= 1e-5


@pytest.mark.parametrize("cin,cout,hw", [(16, 8, (5, 7)), (64, 32, (4, 4))])
def test_dts_up_conv_equals_the_transpose_conv(cin, cout, hw):
    up = UpConv(cin, cout)
    up.init_weights(torch.Generator().manual_seed(1))
    with torch.no_grad():
        up.up.bias.normal_(generator=torch.Generator().manual_seed(2))
    x = torch.randn(2, cin, *hw, generator=torch.Generator().manual_seed(3)).to(
        memory_format=torch.channels_last)
    with torch.no_grad():
        want, got = up(x), step_variants.DtsUpConv(up)(x)
    assert got.shape == want.shape == (2, cout, 2 * hw[0], 2 * hw[1])
    assert (got - want).abs().max().item() <= 1e-5


def _grads_and_stats(variant, step_inputs):
    base_state, x, y, _ = step_inputs
    model, loss = step_variants.make_variant(variant, base_state.model)
    model.train()
    loss(model(x), y).backward()
    return ([p.grad for p in model.parameters()],
            [b.clone() for n, b in model.named_buffers() if "running" in n])


@pytest.mark.parametrize("variant", ["remat", "dts", "fusedloss"])
def test_variant_gradients_equal_base(step_inputs, variant):
    grads, stats = _grads_and_stats("base", step_inputs)
    vgrads, vstats = _grads_and_stats(variant, step_inputs)
    assert len(vgrads) == len(grads)
    for g, v in zip(grads, vgrads):
        if g.shape != v.shape:
            # dts: the up conv's weight relabelled; its bias is 4 copies, whose
            # gradients sum to the transpose conv's
            g, v = ((g.permute(1, 2, 3, 0).reshape(v.shape), v) if g.dim() == 4
                    else (g, v.view(-1, 4).sum(1)))
        assert (g - v).abs().max().item() <= 1e-5
    for s, v in zip(stats, vstats):
        torch.testing.assert_close(v, s, rtol=0, atol=0 if variant == "remat" else 1e-6)


def test_step_variants_main_runs_every_variant(capsys):
    out = step_variants.main(["--device", "cpu", "--steps", "1", "--turns", "1"])
    assert set(out["img_per_sec"]) == set(step_variants.VARIANTS)
    assert all(v > 0 for v in out["img_per_sec"].values())


# -- profile_train_step ----------------------------------------------------

JAX_PROFILE_KEYS = {"fwd", "grad", "loss", "opt", "step", "overhead_vs_3fwd", "img_per_sec"}


def test_profile_train_step_keys_and_step(monkeypatch, tmp_path):
    from image_segmentation_tpu_torch.train import steps

    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return train_step(*a, **kw)

    monkeypatch.setattr(steps, "train_step", counting)
    out = profile_train_step.main(["--device", "cpu", "--steps", "2", "--trace",
                                   str(tmp_path / "trace")])
    assert JAX_PROFILE_KEYS <= set(out)
    assert set(out) - JAX_PROFILE_KEYS == {"spread_ms", "peak_memory_bytes", "batch", "size",
                                           "steps", "device", "card", "tf32", "top_ops"}
    assert (out["batch"], out["size"]) == (4, 64)
    # `step`: one warm-up and 2 timed train_steps; the trace's 3
    assert len(calls) == 3 + profile_train_step.TRACE_STEPS
    assert out["top_ops"] and all(ms >= 0 for ms, _ in out["top_ops"])


# -- backward_anatomy -------------------------------------------------------

@pytest.fixture(scope="module")
def anatomy():
    return backward_anatomy.main(["--device", "cpu", "--per-conv", "--steps", "1",
                                  "--trace-steps", "1"])


def test_anatomy_buckets_cover_the_trace(anatomy):
    assert set(anatomy["buckets_ms_per_step"]) == set(backward_anatomy.BUCKETS)
    for k in ("fwd/conv", "fwd/bn", "fwd/pool", "bwd/conv", "bwd/bn", "bwd/pool", "loss",
              "optimizer/update"):
        assert anatomy["buckets_ms_per_step"][k] > 0, k
    assert abs(sum(anatomy["shares"].values()) - 1.0) <= 1e-6
    assert abs(anatomy["attributed_share"] - 1.0) <= 1e-6
    assert anatomy["bwd_over_fwd"] > 0


# (layer, kind) → (N, H, W, Cin, Cout, k²) by hand: 4 × 64² at base 8;
# H × W the output's, the transpose conv's the input's
HAND = {("down1.conv1", "fwd"): (4, 64, 64, 3, 8, 9),
        ("down1.conv1", "wgrad"): (4, 64, 64, 3, 8, 9),
        ("down2.conv.conv1", "dgrad"): (4, 32, 32, 8, 16, 9),
        ("down5.conv.conv2", "wgrad"): (4, 4, 4, 128, 128, 9),
        ("up1.up", "fwd"): (4, 4, 4, 128, 64, 4),
        ("up1.up", "dgrad"): (4, 4, 4, 128, 64, 4),
        ("up4.conv.conv1", "fwd"): (4, 64, 64, 16, 8, 9),
        ("output", "wgrad"): (4, 64, 64, 8, 4, 1)}


@pytest.mark.parametrize("key", list(HAND))
def test_anatomy_conv_gflops_are_hand_counts(anatomy, key):
    rows = {(r["layer"], r["kind"]): r for r in anatomy["per_conv"]["rows"]}
    n, h, w, cin, cout, k2 = HAND[key]
    assert rows[key]["gflops"] == pytest.approx(2 * n * h * w * cin * cout * k2 / 1e9, rel=1e-12)
    assert rows[key]["ms"] > 0


def test_anatomy_rows_cover_every_conv(anatomy):
    rows = {(r["layer"], r["kind"]) for r in anatomy["per_conv"]["rows"]}
    # 18 3×3 convs, 4 transpose convs and the head; the stem's input needs
    # no gradient, so its first conv has no dgrad
    layers = {l for l, _ in rows}
    assert len(layers) == 23
    assert ("down1.conv1", "dgrad") not in rows
    assert len(rows) == 4 * 23 - 1
    assert ("down3.conv.conv2", "bias") in rows
    bias = next(r for r in anatomy["per_conv"]["rows"]
                if (r["layer"], r["kind"]) == ("down3.conv.conv2", "bias"))
    assert bias["gflops"] == pytest.approx(4 * 16 * 16 * 32 / 1e9)


def test_anatomy_layers_from_sequence_numbers_match_backward_hooks():
    """Layers of ConvolutionBackward nodes from their sequence_nr (the
    probe's way) against `bwd::<path>` scopes pushed by full backward hooks
    on each ConvBNRelu and UpConv."""
    from image_segmentation_tpu_torch.models.layers import ConvBNRelu

    state, x, y, loss_fn = production_step("cpu")
    model = state.model
    stack, handles = [], []
    for name, m in model.named_modules():
        if isinstance(m, (ConvBNRelu, UpConv)):
            def pre(mod, grad_out, name=name):
                scope = record_function(f"bwd::{name}")
                scope.__enter__()
                stack.append(scope)

            def post(mod, grad_in, grad_out):
                stack.pop().__exit__(None, None, None)
            handles += [m.register_full_backward_pre_hook(pre), m.register_full_backward_hook(post)]
    with backward_anatomy.module_scopes(model), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, loss_fn, x, y)
    for h in handles:
        h.remove()
    attr = backward_anatomy.Attribution(model, prof.events())
    checked = 0
    for e in prof.events():
        if e.name == backward_anatomy.BACKWARD + "ConvolutionBackward0":
            hooked = next((a.name[len("bwd::"):] for a in backward_anatomy._chain(e)
                           if a.name.startswith("bwd::")), None)
            layer = attr.forward[e.sequence_nr][0]
            if hooked is not None:
                assert layer == hooked
                checked += 1
    # every 3×3 and transpose conv but the stem's first, whose input needs no
    # gradient (its hooks fire together at its output); the head has none
    assert checked == 21


# -- reference_recipe and reference_anchor ----------------------------------

@pytest.fixture(scope="module")
def jax_anchor():
    return load_jax_file("benchmarks/reference_anchor.py", "jax_reference_anchor")


def test_ref_unet_holds_jax_anchor_state_dict(jax_anchor):
    want = jax_anchor._build_ref_unet()
    got = reference_recipe.RefUNet()
    got.load_state_dict(want.state_dict())
    assert sum(p.numel() for p in got.parameters()) == sum(p.numel() for p in want.parameters())
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    for mode in ("train", "eval"):
        getattr(got, mode)(), getattr(want, mode)()
        with torch.no_grad():
            assert (got(x) - want(x)).abs().max().item() <= 1e-6, mode
    # the seeded build is the anchor's, bit for bit
    for a, b in zip(reference_recipe.build_ref_unet().state_dict().values(),
                    jax_anchor._build_ref_unet().state_dict().values()):
        assert torch.equal(a, b)


def test_ref_unet_carries_into_the_port_unet():
    from image_segmentation_tpu_torch.models.unet import UNet

    ref = reference_recipe.build_ref_unet(8, seed=4)
    model = UNet(base=8)
    model.load_state_dict(reference_recipe.port_state_dict(ref))
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    for mode in ("train", "eval"):
        getattr(ref, mode)(), getattr(model, mode)()
        with torch.no_grad():
            got = model(x)
            want = ref(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert (got - want).abs().max().item() <= 1e-5, mode


def test_samechip_window_equals_train_step_accumulation():
    model = reference_anchor.samechip_model("cpu", base=8)
    twin = copy.deepcopy(model)
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 4, (8, 32, 32)))
    loss_fn = DiceCELoss()
    opt, _ = make_adamw(model.parameters(), learning_rate=1e-3, weight_decay=0.01)
    losses = reference_anchor.samechip_window(
        model, opt, loss_fn, [(xs[i:i + 2], ys[i:i + 2]) for i in range(0, 8, 2)], accum=4)
    state = TrainState(twin, make_adamw(twin.parameters(), learning_rate=1e-3,
                                        weight_decay=0.01)[0])
    mean = train_step(state, loss_fn, xs, ys, accum_steps=4)
    assert abs(float(mean) - float(np.mean(losses))) <= 1e-6
    for (name, a), b in zip(model.state_dict().items(), twin.state_dict().values()):
        assert (a - b).abs().max().item() <= 1e-5, name


def test_reference_anchor_samechip_main_on_the_cpu():
    out = reference_anchor.main(["--mode", "torch-samechip", "--steps", "2", "--device", "cpu"])
    assert out["mode"] == "torch-samechip-fp32-microbatch2" and out["images_per_sec"] > 0
    assert (out["micro_batch"], out["accum_steps"], out["base"]) == (2, 32, 8)
    assert out["tf32"] == {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                           "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


@pytest.mark.parametrize("module", ["confusion_probe", "eval_bench", "serve_profile",
                                    "profile_train_step", "step_variants", "backward_anatomy",
                                    "reference_anchor"])
def test_probes_default_to_the_card(module, monkeypatch):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"image_segmentation_tpu_torch.probes.{module}")
    argv = ["--mode", "torch-samechip"] if module == "reference_anchor" else []
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(argv)
