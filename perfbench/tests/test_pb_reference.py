"""The plain reference (perfbench/reference/) agrees with the port's CPU
float32 path at a small size on the same seeded weights: the forwards in
eval and train mode, the running statistics, the loss, AdamW, and the
serving geometry. The test imports the port; the reference does not."""
import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference import geometry as ref_geometry
from perfbench.reference import train as ref_train

SEED = 2**31 + 5


def _pair(cell):
    w = harness.make_weights(cell.builder, cell.cfg, SEED, "cpu")
    port = harness.build(cell.builder, cell.cfg, "cpu", w, "port")
    ref = harness.build(cell.builder, cell.cfg, "cpu", w, "reference")
    return port, ref


def _images(cell, n=3):
    s = cell.cfg["image_size"]
    return torch.rand((n, s, s, 3), generator=torch.Generator().manual_seed(3))


@pytest.mark.parametrize("workload", ["unet64_train_b64", "clipunet_train_b64"])
def test_eval_forward_matches_port(tiny_cell, workload):
    cell = tiny_cell(workload)
    port, ref = _pair(cell)
    x = _images(cell)
    with torch.no_grad():
        a, b = port(x), ref(x)
    assert a.shape == b.shape == x.shape[:3] + (cell.cfg["num_classes"],)
    assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())


@pytest.mark.parametrize("workload", ["unet64_train_b64", "clipunet_train_b64"])
def test_train_forward_and_running_statistics_match_port(tiny_cell, workload):
    cell = tiny_cell(workload)
    port, ref = _pair(cell)
    port.train()
    ref.train()
    x = _images(cell)
    a, b = port(x), ref(x)
    assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * b.abs().max().item())
    rp, rr = port.state_dict(), ref.state_dict()
    for k in rr:
        if k.endswith(("running_mean", "running_var")):
            assert torch.allclose(rp[k], rr[k], rtol=1e-4, atol=1e-6), k


def test_loss_matches_port():
    from image_segmentation_tpu_torch.losses import DiceCELoss

    g = torch.Generator().manual_seed(0)
    logits = torch.randn((2, 8, 8, 4), generator=g)
    labels = torch.randint(0, 4, (2, 8, 8), generator=g)
    weights = (0.2047, 1.0272, 1.2293, 1.5388)
    want = DiceCELoss(class_weights=weights, smooth_dice=1.0)(logits, labels)
    got = ref_train.dice_ce_loss(logits, labels, weights, 1.0)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_adamw_matches_the_ports_optimizer():
    from image_segmentation_tpu_torch.train.state import make_adamw

    g = torch.Generator().manual_seed(1)
    p0 = torch.randn(50, generator=g)
    grads = [torch.randn(50, generator=g) for _ in range(3)]
    a = p0.clone().requires_grad_(True)
    opt, _ = make_adamw([a], learning_rate=1e-3, weight_decay=0.01)
    b = p0.clone()
    ref = ref_train.AdamW([b], 1e-3, 0.01)
    for gr in grads:
        a.grad = gr.clone()
        opt.step()
        ref.step([gr])
    assert torch.allclose(a.detach(), b, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("hw", [(37, 53), (60, 20), (32, 32), (90, 91)])
def test_geometry_matches_the_engine(hw):
    from image_segmentation_tpu_torch.serve.engine import ModelEntry, stage_request
    from image_segmentation_tpu_torch.ops import geometry as G

    rng = np.random.default_rng(hw[0])
    photo = rng.integers(0, 256, hw + (3,)).astype(np.float32) / 255.0
    entry = ModelEntry("m", None, 32, ("a", "b", "c", "d"))
    (staged,), meta = stage_request(photo, entry, None, fast_transfer=True)
    mine = ref_geometry.stage(photo, 32)
    diff = np.abs(staged.astype(np.float64) / 255.0 - mine)
    assert diff.max() <= 1 / 255 + 1e-9  # a rounding at a .5 boundary at most
    assert (diff > 0).mean() < 0.01
    scores = rng.standard_normal((32, 32, 4)).astype(np.float32)
    got = ref_geometry.unstage(scores.astype(np.float64), *hw)
    want = G.invert_resize_padding_np(scores, meta, method="linear")
    assert np.allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("workload", ["unet64_train_b64", "clipunet_train_b64"])
def test_the_configurations_norms_act_in_the_reference(tiny_cell, workload):
    cell = tiny_cell(workload)
    w = harness.make_weights(cell.builder, cell.cfg, SEED, "cpu")
    x = _images(cell)
    out = {}
    for key, value in (("bn_eps", None), ("bn_eps", 0.5), ("bn_momentum", 0.5),
                       ("layer_norm_eps", 0.5)):
        if key not in cell.cfg:
            continue
        cfg = dict(cell.cfg, **({key: value} if value is not None else {}))
        ref = harness.build(cell.builder, cfg, "cpu", w, "reference").train()
        out[(key, value)] = (ref(x).detach(), ref.state_dict())
    base_y, _ = out.pop(("bn_eps", None))
    for (key, _), (y, state) in out.items():
        if key == "bn_momentum":  # the running statistics move by it, not the batch's output
            base = harness.build(cell.builder, cell.cfg, "cpu", w, "reference").train()
            base(x)
            k = next(k for k in state if k.endswith("running_mean"))
            assert not torch.allclose(state[k], base.state_dict()[k]), key
        else:
            assert not torch.allclose(y, base_y), key


@pytest.mark.parametrize("workload", ["unet64_train_b64", "clipunet_train_b64"])
def test_a_configuration_the_port_cannot_run_is_refused(tiny_cell, workload):
    cell = tiny_cell(workload)
    with pytest.raises(ValueError, match="BatchNorm"):
        cell.builder.port(dict(cell.cfg, bn_eps=1e-3), "cpu")
    w = harness.make_weights(cell.builder, cell.cfg, SEED, "cpu")
    with pytest.raises(ValueError, match="parameters"):
        harness.build(cell.builder, dict(cell.cfg, param_dtype="bfloat16"), "cpu", w, "port")
    if "hidden_act" in cell.cfg:
        with pytest.raises(ValueError, match="quick_gelu"):
            cell.builder.reference(dict(cell.cfg, hidden_act="gelu"))


def test_an_unknown_size_mix_is_refused():
    from perfbench.kinds import serve_open

    with pytest.raises(ValueError, match="size mix"):
        serve_open.pet_sizes(3, np.random.default_rng(0), {"mix": "coco"})
