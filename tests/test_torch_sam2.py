"""SAM 2.1 Hiera-B+ in the port (models/hiera.py, models/sam2.py), held on
the CPU against the benchmark's plain reference (perfbench/reference/
sam2.py) on seeded random weights, at the published widths (112 wide, 2
heads, head dim 56 in every stage) with fewer blocks and a 256 px input:
a 64 x 64 map in windows of 8, a pooled block that attends in windows of
8, stage 3's 16 x 16 map in windows of 14 (padded to 28) beside one
global block, and a pooled block in windows of 14 that crops its padded
windows to the 8 x 8 stage-4 map, which windows of 7 pad to 14. Float32
on both sides: they differ only in the order of their sums. Also SAM 2's
decoder options (SamViTB's decoder with its defaults is SAM's, bit for
bit), the kernel path against the plain path, the spans and counts, a
train step's gradients, and the benchmark cell at CPU size."""
import copy
import dataclasses
import json
import os
import sys
import time

import pytest
import torch

from image_segmentation_tpu_torch import config
from image_segmentation_tpu_torch.losses import SamLoss
from image_segmentation_tpu_torch.models import hiera as H
from image_segmentation_tpu_torch.models import sam as S
from image_segmentation_tpu_torch.models import sam2 as S2
from image_segmentation_tpu_torch.train.state import TrainState, freeze_, make_adamw
from image_segmentation_tpu_torch.train.state import trainable_parameters
from image_segmentation_tpu_torch.train.steps import train_step
from image_segmentation_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import sam_reference as R  # noqa: E402
import test_torch_sam as T  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench.reference import sam2 as ref2  # noqa: E402

torch.set_num_threads(2)

# The smallest cut with every stage (stage 2 is its pooled block alone,
# stage 4 too) and one with a block at windows of 4 (SDPA) and one at 7.
CUTS = {"stages_1131": ((1, 1, 3, 1), (4,)), "stages_1232": ((1, 2, 3, 2), (5,))}


def _cfg(cut="stages_1131", image_size=256):
    stages, glob = CUTS[cut]
    return S2.Sam2Config(image_size=image_size,
                         hiera=H.HieraConfig(stages=stages, global_att_blocks=glob))


def _biased(model, seed=1):
    """Non-zero biases everywhere (init_weights zeroes them), so that pad
    keys differ from zero tokens and every bias acts."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model


def _pair(cut="stages_1131", seed=0):
    cfg = _cfg(cut)
    port = _biased(S2.Sam2HieraBPlus(cfg).init_weights(torch.Generator().manual_seed(seed)))
    stages, glob = CUTS[cut]
    ref = ref2.Sam2(image_size=cfg.image_size, stages=stages, global_att_blocks=glob,
                    head_chunk=1)
    ref.load_state_dict(port.state_dict())
    return port, ref


def _batch(n=2, seed=0, size=256):
    g = torch.Generator().manual_seed(seed)
    images = torch.rand((n, size, size, 3), generator=g)
    labels = torch.randint(0, 4, (n, size, size), generator=g)
    xy = torch.randint(0, size, (n, 1, 2), generator=g).float()
    return images, torch.cat([xy, torch.ones(n, 1, 1)], dim=-1), labels


@pytest.mark.parametrize("cut", list(CUTS))
def test_forward_matches_reference(cut):
    port, ref = _pair(cut)
    images, clicks, _ = _batch()
    with torch.no_grad():
        masks, iou = port(images, clicks)
        want_masks, want_iou = ref(images, clicks)
    assert masks.shape == (2, 3, 64, 64) and iou.shape == (2, 3)
    assert masks.dtype == iou.dtype == torch.float32
    assert ((iou > 0) & (iou < 1)).all()  # the sigmoid IoU head
    # float32 through a 896-wide stage: sums in another order, 1e-4 of the masks' scale
    torch.testing.assert_close(masks, want_masks, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(iou, want_iou, rtol=1e-4, atol=1e-6)


def test_cut_pads_crops_and_pools_as_described():
    """At 256 px the stage maps are 64, 32, 16 and 8 tokens a side: stage
    3's windows of 14 pad 16 to 28, the stage-4 pooled block pools 14 x 14
    windows of the padded 28 x 28 map and crops the pooled 14 x 14 to 8 x 8,
    and stage 4's windows of 7 pad 8 to 14."""
    specs = _cfg("stages_1232").hiera.blocks()
    assert [(s["window"], s["pool"], s["dim_out"], s["heads"]) for s in specs] == [
        (8, False, 112, 2), (8, True, 224, 4), (4, False, 224, 4), (4, True, 448, 8),
        (14, False, 448, 8), (0, False, 448, 8), (14, True, 896, 16), (7, False, 896, 16)]
    port, _ = _pair("stages_1232")
    sides = []
    for block in port.image_encoder.trunk.blocks:
        block.register_forward_hook(lambda m, a, out: sides.append(out.shape[1]))
    images, clicks, _ = _batch(n=1)
    with torch.no_grad():
        port(images, clicks)
    assert sides == [64, 32, 32, 16, 16, 16, 8, 8]


def test_published_widths_and_parameter_counts():
    port, ref = _pair()
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    with torch.device("meta"):
        full = S2.Sam2HieraBPlus()
    specs = full.cfg.hiera.blocks()
    assert len(specs) == 24 and {s["dim_out"] // s["heads"] for s in specs} == {56}
    assert [i for i, s in enumerate(specs) if s["pool"]] == [2, 5, 21]
    assert [i for i, s in enumerate(specs) if not s["window"]] == [12, 16, 20]
    assert [specs[i]["window"] for i in (2, 5, 21)] == [8, 4, 14]
    assert full.cfg.hiera.channel_list == [896, 448, 224, 112] and full.cfg.grid_size == 64
    assert sum(p.numel() for p in full.parameters()) == 73_323_717
    assert sum(p.numel() for p in full.image_encoder.parameters()) == 69_106_816
    assert sum(p.numel() for p in full.image_encoder.trunk.parameters()) == 68_675_712
    trunk = full.image_encoder.trunk
    assert tuple(trunk.pos_embed.shape) == (1, 112, 14, 14)
    assert tuple(trunk.pos_embed_window.shape) == (1, 112, 8, 8)
    dec = full.sam_mask_decoder
    assert tuple(dec.conv_s0.weight.shape) == (32, 256, 1, 1)
    assert tuple(dec.conv_s1.weight.shape) == (64, 256, 1, 1)
    assert tuple(full.no_mem_embed.shape) == (1, 1, 256)


def test_no_mem_embed_and_high_res_levels_reach_the_masks():
    """The image path adds `no_mem_embed` to the embedding and the decoder
    reads both finer levels through conv_s0 and conv_s1: zeroing either
    moves the masks; the IoU comes through the sigmoid."""
    port, _ = _pair()
    images, clicks, _ = _batch()
    with torch.no_grad():
        base = port(images, clicks)[0]
        for name in ("no_mem_embed", "sam_mask_decoder.conv_s0.weight",
                     "sam_mask_decoder.conv_s1.weight"):
            p = dict(port.named_parameters())[name]
            keep = p.clone()
            p.zero_()
            assert (port(images, clicks)[0] - base).abs().max() > 1e-3, name
            p.copy_(keep)


def test_decoder_options_default_to_sams_decoder():
    """SamViTB's decoder, built with the defaults, has none of SAM 2's
    parameters and gives SAM's outputs (tests/sam_reference.py), exactly as
    before the options; a decoder built with the high-resolution path
    refuses to run without its levels."""
    port, ref = T._pair()
    assert not any(k.split(".")[1] in ("obj_score_token", "conv_s0", "conv_s1",
                                       "pred_obj_score_head")
                   for k in port.state_dict() if k.startswith("mask_decoder."))
    images, clicks, _ = T._batch(T.SMALL)
    with torch.no_grad():
        for a, b in zip(port(images, clicks), ref(images, clicks)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    dec = S.MaskDecoder(T.SMALL, high_res=True)
    g = T.SMALL.grid_size
    with pytest.raises(ValueError, match="high-resolution"):
        dec(torch.zeros(1, 32, g, g), torch.zeros(1, 32, g, g), torch.zeros(1, 2, 32),
            torch.zeros(1, 32, g, g))


def test_kernel_path_matches_the_plain_path(monkeypatch):
    """The kernel path (on the CPU: K5's no-table entries' plain versions,
    the windowed blocks on the unpadded map) against the plain path (pad,
    partition, K5's plain version, crop): the K5 windowed blocks partition
    nothing; the pooled and small-window blocks partition on both."""
    partitions = []
    real = H.window_partition
    monkeypatch.setattr(H, "window_partition", lambda *a: partitions.append(1) or real(*a))
    plain, _ = _pair("stages_1232")
    kernels = S2.Sam2HieraBPlus(_cfg("stages_1232"), use_kernels=True)
    kernels.load_state_dict(plain.state_dict())
    images, clicks, _ = _batch()
    with torch.no_grad():
        got = kernels(images, clicks)
        assert len(partitions) == 4  # three pooled blocks, one at windows of 4
        want = plain(images, clicks)
        assert len(partitions) == 4 + 7  # and the three K5 windowed blocks
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_kernel_path_runs_k4_once_a_block(monkeypatch):
    """Each block's second half, x + fc2(GELU(fc1(LN2(x)))), is one
    `fused_mlp` call on the kernel path (the exact GELU, Hiera's eps, a
    contiguous map at the block's output width, weights in the compute
    dtype, LayerNorm parameters and biases in f32), and none on the plain
    path, which runs K4's plain version: both give the same masks."""
    calls = []

    def spy(x, ln_w, ln_b, w1, b1, w2, b2, eps, activation):
        calls.append((x.shape[-1], w1.shape[0], x.is_contiguous(), eps, activation,
                      w1.dtype, ln_w.dtype, b1.dtype))
        return H.mlp_reference(x, ln_w, ln_b, w1, b1, w2, b2, eps, activation)

    monkeypatch.setattr(H, "fused_mlp", spy)
    plain, _ = _pair("stages_1232")
    kernels = S2.Sam2HieraBPlus(_cfg("stages_1232"), use_kernels=True)
    kernels.load_state_dict(plain.state_dict())
    images, clicks, _ = _batch()
    with torch.no_grad():
        want = plain(images, clicks)
        assert calls == []
        got = kernels(images, clicks)
    widths = [b.mlp.layers[1].out_features for b in kernels.image_encoder.trunk.blocks]
    assert widths == [112, 224, 224, 448, 448, 448, 896, 896]
    assert calls == [(h, 4 * h, True, 1e-6, "gelu", torch.float32, torch.float32,
                      torch.float32) for h in widths]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_spans_and_counts_of_a_forward():
    port, _ = _pair("stages_1232")
    images, clicks, _ = _batch(n=3)
    with profiling.record_spans() as log, torch.no_grad():
        port(images, clicks)
    assert [s.name for s in log.spans] == [
        "sam.image_encoder", "sam.hiera_stage1", "sam.hiera_stage2", "sam.hiera_stage3",
        "sam.hiera_stage4", "sam.neck", "sam.prompt_encoder", "sam.mask_decoder"]
    # pad tokens: stage 3's 16 x 16 in windows of 14 (28² − 16² = 528), the
    # stage-4 pooled block's the same, stage 4's 8 x 8 in windows of 7 (14² − 8²)
    assert dict(log.counts) == {"sam.window_attention": 3, "sam.global_attention": 1,
                                "sam.plain_window_attention": 1, "sam.pooled_attention": 3,
                                "sam.window_pad_tokens": 3 * (528 + 528 + 132)}


def test_full_size_forward_counts_each_kind_of_block():
    """At 1024 px the 24 blocks count 16 K5 windowed, 3 global, 2 small-window
    and 3 pooled calls, and the pad of stage 3 (12 blocks and block 21, 70²
    − 64² each) and stage 4 (2 blocks, 35² − 32² each); one image, the
    encoder alone (the trunk's blocks, not their arithmetic, are counted:
    every block's attention is replaced by zeros)."""
    with torch.device("meta"):
        model = S2.Sam2HieraBPlus()
    for block in model.image_encoder.trunk.blocks:
        dim = block.attn.proj.out_features
        block.attn.forward = lambda x, pool=0, sdpa=True, d=dim: x.new_zeros(
            x.shape[0], x.shape[1] // max(pool, 1), x.shape[2] // max(pool, 1), d)
        block.attn.global_kernel = lambda x, d=dim: x.new_zeros(x.shape[:3] + (d,))
        block.attn.window_kernel = lambda x, ws, d=dim: x.new_zeros(x.shape[:3] + (d,))
    with profiling.record_spans() as log, torch.no_grad():
        model.image_encoder(torch.zeros(1, 1024, 1024, 3, device="meta"))
    assert dict(log.counts) == {"sam.window_attention": 16, "sam.global_attention": 3,
                                "sam.plain_window_attention": 2, "sam.pooled_attention": 3,
                                "sam.window_pad_tokens": 13 * 804 + 2 * 201}


def test_train_step_loss_and_gradients_match_reference():
    """One `train_step` of 2 micro-batches of 1, the encoder frozen: the
    step's loss and each trained parameter's gradient as the reference's
    autograd gives them; the encoder gets none, `no_mem_embed` and the
    high-resolution convs do."""
    port, ref = _pair()
    freeze_(port, ("image_encoder",))
    opt, _ = make_adamw(trainable_parameters(port, ("image_encoder",)), 8e-4, 0.1)
    state = TrainState(port, opt)
    images, clicks, labels = _batch()
    loss = train_step(state, SamLoss(), (images, clicks), labels, accum_steps=2)
    params = R.trainable(ref)
    losses = []
    for rows in (slice(0, 1), slice(1, 2)):
        lo, _ = R.sam_loss(*ref(images[rows], clicks[rows]), labels[rows])
        lo.backward()
        losses.append(lo.detach())
    torch.testing.assert_close(loss, torch.stack(losses).mean(), rtol=1e-5, atol=1e-6)
    got = dict(port.named_parameters())
    assert not any(p.grad is not None for n, p in got.items() if n.startswith("image_encoder"))
    for name in ("no_mem_embed", "sam_mask_decoder.conv_s0.weight",
                 "sam_mask_decoder.conv_s1.bias"):
        assert got[name].grad is not None and got[name].grad.abs().sum() > 0, name
    compared = 0
    for name, p in params.items():
        if p.grad is None:  # no click or chosen mask reaches them
            assert got[name].grad is None or not got[name].grad.any()
            continue
        torch.testing.assert_close(got[name].grad, p.grad / 2, rtol=1e-3, atol=1e-6)
        compared += 1
    assert compared > 60


def test_build_model_builds_sam2_from_config():
    cfg = dataclasses.replace(config.CLIPUNET, name="sam2", model="sam2_hiera_bplus")
    model = config.build_model(cfg, "cpu", torch.Generator().manual_seed(0), sam2=_cfg())
    assert isinstance(model, S2.Sam2HieraBPlus)
    assert config.MODELS["sam2_hiera_bplus"] == (S2.Sam2HieraBPlus, True)
    assert not model.training and all(p.dtype == torch.float32 for p in model.parameters())


def test_reference_partition_and_pool_are_hieradets():
    x = torch.randn(2, 9, 11, 4)
    win, pad = ref2.window_partition(x, 4)
    assert win.shape == (2 * 3 * 3, 4, 4, 4) and pad == (12, 12)
    assert torch.equal(ref2.window_unpartition(win, 4, pad, (9, 11)), x)
    torch.testing.assert_close(ref2.do_pool(x, 2), torch.nn.MaxPool2d(2, 2)(
        x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1), rtol=0, atol=0)


# -- the benchmark cell at CPU size -------------------------------------------------

TINY = {"image_size": 256, "stages": [1, 2, 3, 2], "global_att_blocks": [5]}


def _tiny_cell():
    from perfbench import harness

    cell = copy.copy(harness.load_cell("sam2_hiera_bplus_train_clicks_b64"))
    cell.cfg = dict(cell.cfg, **TINY)
    cell.traffic = dict(cell.traffic, **T.TINY_TRAFFIC)
    return cell


def test_benchmark_cell_is_declared_and_counts_at_full_size():
    from perfbench import harness
    from perfbench.tracing import Reading, Spans

    bench = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.load_cell("sam2_hiera_bplus_train_clicks_b64")
    assert cell.chips == 1 and cell.traffic["kind"] == "train_clicks"
    assert cell.traffic == harness.load_cell("sam_vitb_train_clicks_b64").traffic
    assert {m["name"] for m in cell.per_layer} == {
        "train_mfu", "step_device_ms.train", "device_idle_pct.train", "k5_roofline.train",
        "k5_device_ms.train"}
    conf = next(c for c in bench["configs"] if c["name"] == "sam2_hiera_bplus")
    assert conf["reduced"] == []
    b = cell.builder
    ref = b.reference(cell.cfg)
    assert sum(p.numel() for p in ref.parameters()) == cell.cfg["parameters"] == 73_323_717
    assert sum(p.numel() for n, p in ref.named_parameters()
               if n.startswith("image_encoder.")) == cell.cfg["image_encoder_parameters"]
    assert sum(p.numel() for n, p in ref.named_parameters()
               if n.startswith("image_encoder.trunk.")) == cell.cfg["trunk_parameters"]
    calls = b.k5_calls(cell.cfg, 8)
    assert len(calls) == 19
    assert calls.count((8 * 65536, 64, 2, 56)) == 2 and calls.count((8 * 4096, 196, 8, 56)) == 12
    assert calls.count((8 * 4096, 4096, 8, 56)) == 3 and calls.count((8 * 1024, 49, 16, 56)) == 2
    assert b.k5_counts(8 * 4096, 4096, 8, 56) == (4 * 8 * 4096 * 4096 * 8 * 56,
                                                  2 * 4 * 8 * 4096 * 8 * 56)
    assert 640e9 < b.encoder_flops(cell.cfg) < 650e9
    assert 0.97 < b.encoder_flops(cell.cfg) / b.train_flops(cell.cfg) < 1.0
    for m in ("k5_roofline.train", "k5_device_ms.train"):
        assert harness.metric_reader(m)(Reading(Spans(False), None, {})) is None


def test_benchmark_port_and_reference_agree_on_seeded_weights():
    from perfbench import harness

    cell = _tiny_cell()
    weights = harness.make_weights(cell.builder, cell.cfg, 2**31 + 3, "cpu")
    port = harness.build(cell.builder, cell.cfg, "cpu", weights, "port")
    ref = harness.build(cell.builder, cell.cfg, "cpu", weights, "reference")
    images, clicks, _ = _batch(n=2)
    with torch.no_grad():
        for a, b in zip(port(images, clicks), ref(images, clicks)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_benchmark_kind_runs_correct_on_the_cpu():
    """The cell's kind at CPU size: the checked steps through `train_step`, a
    short window, and the check against the reference in float32 on both
    sides, which passes with room; both sides pick the same masks."""
    cell = _tiny_cell()
    outcome = cell.kind.run(cell, 2**31 + 77, 0.3, False, "cpu", time.perf_counter())
    assert outcome.attempted >= 1 and outcome.e2e["train_images_per_s"] > 0
    checks = {c.name: c for c in outcome.checks}
    assert all(c.ok for c in checks.values()), outcome.checks
    assert checks["loss_rms_rel"].value < 1e-4 and checks["grad1_median_rel"].value < 1e-4
    assert outcome.detail["choice_differs"] == 0
    json.dumps(outcome.detail)


@pytest.mark.parametrize("fault, failing", [("unchanged", "change_rel"),
                                            ("half_batch", "loss_rms_rel")])
def test_benchmark_faults_are_caught(fault, failing):
    cell = _tiny_cell()
    outcome = cell.kind.run(cell, 7, 0.1, False, "cpu", time.perf_counter(), fault=fault,
                            window=False)
    assert not {c.name: c for c in outcome.checks}[failing].ok, fault
