"""Segment Anything ViT-B in the port (models/sam.py), its kernels' plain
versions (K5 `relpos_attention`, K4 with the exact GELU), its loss, its
train step through `train_step`, and its benchmark cell, held on the CPU
against the plain reference (tests/sam_reference.py) at a small size on
seeded random weights: 64 px, 16 px patches (a 4 × 4 grid), windows of 3
(the grid padded to 6, four windows) with a global block among the
windowed ones, widths cut. Float32 on both sides: the port's plain
versions and the reference differ only in the order of their sums."""
import copy
import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch import config
from image_segmentation_tpu_torch.losses import SamLoss, sam_loss_terms
from image_segmentation_tpu_torch.models import sam as S
from image_segmentation_tpu_torch.ops.kernels import mlp as K4
from image_segmentation_tpu_torch.ops.kernels import relpos_attention as K5
from image_segmentation_tpu_torch.train import graphs as G
from image_segmentation_tpu_torch.train.state import TrainState, freeze_, make_adamw
from image_segmentation_tpu_torch.train.state import trainable_parameters
from image_segmentation_tpu_torch.train.steps import ResidentTrainSet, train_step
from image_segmentation_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import sam_reference as R  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(1)

SMALL = S.SamConfig(image_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=2,
                    mlp_dim=64, window_size=3, global_attn_indexes=(1,), prompt_embed_dim=32,
                    decoder_num_heads=2, decoder_mlp_dim=64, iou_head_hidden_dim=32)
# windows that tile the grid (no padding), two global blocks
UNPADDED = dataclasses.replace(SMALL, image_size=96, window_size=3, depth=4,
                               global_attn_indexes=(0, 3))


def _pair(sam=SMALL, seed=0):
    port = S.SamViTB(sam).init_weights(torch.Generator().manual_seed(seed))
    ref = R.Sam(**dataclasses.asdict(sam), head_chunk=1)
    ref.load_state_dict(port.state_dict())
    return port, ref


def _batch(sam, n=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    s = sam.image_size
    images = torch.rand((n, s, s, 3), generator=g)
    labels = torch.randint(0, 4, (n, s, s), generator=g)
    xy = torch.randint(0, s, (n, 1, 2), generator=g).float()
    lab = torch.randint(0, 2, (n, 1, 1), generator=g).float()
    return images, torch.cat([xy, lab], dim=-1), labels


@pytest.mark.parametrize("sam", [SMALL, UNPADDED], ids=["padded_windows", "tiled_windows"])
def test_forward_matches_reference(sam):
    port, ref = _pair(sam)
    images, clicks, _ = _batch(sam)
    with torch.no_grad():
        masks, iou = port(images, clicks)
        want_masks, want_iou = ref(images, clicks)
    g4 = 4 * sam.grid_size
    assert masks.shape == (4, 3, g4, g4) and iou.shape == (4, 3)
    assert masks.dtype == iou.dtype == torch.float32
    torch.testing.assert_close(masks, want_masks, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(iou, want_iou, rtol=1e-4, atol=1e-5)


def test_state_dict_names_are_sams_and_the_references():
    port, ref = _pair()
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    with torch.device("meta"):
        full = S.SamViTB()
    assert sum(p.numel() for p in full.parameters()) == 93_730_788
    assert sum(p.numel() for p in full.image_encoder.parameters()) == 89_670_912
    assert tuple(full.image_encoder.blocks[2].attn.rel_pos_h.shape) == (127, 64)
    assert tuple(full.image_encoder.blocks[0].attn.rel_pos_w.shape) == (27, 64)


def test_train_step_loss_and_gradients_match_reference():
    """One `train_step` of 2 micro-batches of 2, the encoder frozen: the
    step's loss and each trained parameter's gradient as the reference's
    autograd gives them (summed over micro-batches, divided by 2)."""
    port, ref = _pair()
    freeze_(port, ("image_encoder",))
    opt, _ = make_adamw(trainable_parameters(port, ("image_encoder",)), 8e-4, 0.1)
    state = TrainState(port, opt)
    images, clicks, labels = _batch(SMALL)
    loss = train_step(state, SamLoss(), (images, clicks), labels, accum_steps=2)
    params = R.trainable(ref)
    losses = []
    for rows in (slice(0, 2), slice(2, 4)):
        lo, _ = R.sam_loss(*ref(images[rows], clicks[rows]), labels[rows])
        lo.backward()
        losses.append(lo.detach())
    torch.testing.assert_close(loss, torch.stack(losses).mean(), rtol=1e-5, atol=1e-6)
    got = dict(port.named_parameters())
    assert not any(p.grad is not None for n, p in got.items() if n.startswith("image_encoder"))
    compared = 0
    for name, p in params.items():
        if p.grad is None:  # the box-corner point embeddings: no click reaches them
            assert got[name].grad is None or not got[name].grad.any()
            continue
        torch.testing.assert_close(got[name].grad, p.grad / 2, rtol=1e-4, atol=1e-6)
        compared += 1
    assert compared > 50


def _attention_with_terms_materialised(q, k, v, rh, rw, h, w):
    """SAM's own order: (q·scale)·kᵀ, + rel_h and rel_w added to the
    (h, w, h, w) view of the logits, softmax, ·v; (B, S, H, D) in and out."""
    b, s, nh, d = q.shape
    heads = lambda t: t.permute(0, 2, 1, 3).reshape(b * nh, s, d)  # noqa: E731
    qq, kk, vv = heads(q), heads(k), heads(v)
    attn = (qq * d ** -0.5) @ kk.transpose(-2, -1)
    r_q = qq.reshape(b * nh, h, w, d)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh[K5.rel_index(h, "cpu")])
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw[K5.rel_index(w, "cpu")])
    attn = (attn.view(b * nh, h, w, h, w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(b * nh, s, s)
    return (attn.softmax(-1) @ vv).view(b, nh, s, d).permute(0, 2, 1, 3)


@pytest.mark.parametrize("b,h,w,nh,d", [(6, 3, 3, 2, 8), (2, 8, 8, 3, 16), (3, 5, 7, 2, 8)],
                         ids=["padded_window", "global_map", "oblong_map"])
def test_k5_plain_version_matches_materialised_terms(b, h, w, nh, d):
    """A padded window (its last rows and columns the qkv bias, as SAM's
    zero-padded tokens give), a global map, and a map that is not square."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((b, h * w, nh, d), generator=g) for _ in range(3))
    if h == w == 3:  # the padded tokens of the window: keys and values are the bias
        k[:, -4:] = k[:1, -1:]
        v[:, -4:] = v[:1, -1:]
    rh, rw = torch.randn((2 * h - 1, d), generator=g), torch.randn((2 * w - 1, d), generator=g)
    before = K5.LAUNCHES
    got = K5.relpos_attention(q, k, v, rh, rw)
    assert K5.LAUNCHES == before
    want = _attention_with_terms_materialised(q, k, v, rh, rw, h, w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(K5.relpos_attention_op(q, k, v, rh, rw), got, rtol=0, atol=0)


def test_k5_plan_covers_both_call_shapes():
    glob = K5.relpos_plan(8, 4096, 12, 64, 64)
    assert glob.row_tiles and glob.grid == (-(-4096 // (64 * glob.warpgroups)), 12, 8)
    win = K5.relpos_plan(200, 196, 12, 14, 14)
    assert not win.row_tiles and win.grid == (-(-196 // (64 * win.warpgroups)), 12, 200)
    for plan in (glob, win):
        assert 2 <= plan.warpgroups <= 4 and plan.smem_bytes <= 227 * 1024
    assert K5.relpos_plan(3, 32 * 64, 12, 32, 64).row_tiles
    for h, w in ((64, 14), (33, 33), (65, 64)):
        with pytest.raises(ValueError, match="maps"):
            K5.relpos_plan(1, h * w, 12, h, w)


def test_k5_refuses_cuda_arguments_it_cannot_take():
    q = torch.zeros((1, 4, 1, 64), dtype=torch.bfloat16)
    table = torch.zeros((3, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="h x w map"):
        K5._check_cuda_args(q, q, q, table, torch.zeros((5, 64), dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        K5._check_cuda_args(q.float(), q.float(), q.float(), table.float(), table.float())


def _mlp_args(seed=0, h=32, f=64, n=(2, 9)):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n + (h,), generator=g), torch.randn((h,), generator=g),
            torch.randn((h,), generator=g), torch.randn((f, h), generator=g) * 0.2,
            torch.randn((f,), generator=g), torch.randn((h, f), generator=g) * 0.2,
            torch.randn((h,), generator=g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_erf_gelu_plain_version_is_the_exact_gelu(dtype):
    x, lw, lb, w1, b1, w2, b2 = (t.to(dtype) if i in (0, 3, 5) else t
                                 for i, t in enumerate(_mlp_args()))
    got = K4.fused_mlp(x, lw, lb, w1, b1, w2, b2, 1e-6, activation="gelu")
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    hidden = ((xf - mu) * torch.rsqrt(var + 1e-6) * lw + lb).to(dtype)
    hidden = hidden.float() @ w1.float().t() + b1
    hidden = torch.nn.functional.gelu(hidden).to(dtype)
    want = x + (hidden.float() @ w2.float().t() + b2).to(dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    quick = K4.fused_mlp(x, lw, lb, w1, b1, w2, b2, 1e-6)
    assert not torch.equal(got, quick)


def test_k4_quick_gelu_outputs_unchanged():
    """The default activation is quick GELU, computed as before the
    activation argument existed (h·sigmoid(1.702 h) in f32, the kernel's
    casts), bit for bit, by the function, the wrapper and the torch op."""
    args = _mlp_args(1)
    x, lw, lb, w1, b1, w2, b2 = args
    for dtype in (torch.float32, torch.bfloat16):
        xs, w1s, w2s = x.to(dtype), w1.to(dtype), w2.to(dtype)
        xf = xs.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        h = ((xf - mu) * torch.rsqrt(var + 1e-5) * lw + lb).to(dtype)
        h = h.float() @ w1s.float().t() + b1
        g = (h * torch.sigmoid(1.702 * h)).to(dtype)
        want = xs + (g.float() @ w2s.float().t() + b2).to(dtype)
        for got in (K4.fused_mlp(xs, lw, lb, w1s, b1, w2s, b2, 1e-5),
                    K4.mlp_reference(xs, lw, lb, w1s, b1, w2s, b2),
                    K4.mlp_op(xs, lw, lb, w1s, b1, w2s, b2, 1e-5)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="activation"):
        K4.mlp_reference(*args, 1e-5, "relu")


def test_sam_loss_matches_reference_and_picks_per_image():
    g = torch.Generator().manual_seed(3)
    masks = torch.randn((5, 3, 16, 16), generator=g, requires_grad=True)
    iou = torch.rand((5, 3), generator=g, requires_grad=True)
    labels = torch.randint(0, 4, (5, 64, 64), generator=g)
    loss, choice = sam_loss_terms(masks, iou, labels)
    want, want_choice = R.sam_loss(masks, iou, labels)
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-7)
    assert torch.equal(choice, want_choice)
    loss.backward()
    picked = masks.grad.abs().sum(dim=(2, 3)) > 0
    assert picked.sum(1).tolist() == [1] * 5
    assert picked.float().argmax(1).tolist() == choice.tolist()
    assert (iou.grad != 0).all()  # every IoU prediction is trained


def test_the_two_reference_copies_agree():
    from perfbench.reference import sam as bench_ref

    port, ref = _pair()
    bench = bench_ref.Sam(**dataclasses.asdict(SMALL), head_chunk=1)
    bench.load_state_dict(port.state_dict())
    images, clicks, labels = _batch(SMALL)
    out_a, out_b = ref(images, clicks), bench(images, clicks)
    for a, b in zip(out_a, out_b):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    la, ca = R.sam_loss(*out_a, labels)
    lb, cb = bench_ref.sam_loss(*out_b, labels)
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    assert torch.equal(ca, cb)


def test_global_blocks_in_blocks_of_heads_change_nothing():
    port, ref = _pair(UNPADDED)
    images, clicks, _ = _batch(UNPADDED, n=2)
    whole = R.Sam(**dataclasses.asdict(UNPADDED), head_chunk=8)
    whole.load_state_dict(port.state_dict())
    with torch.no_grad():
        for a, b in zip(ref(images, clicks), whole(images, clicks)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_spans_and_counts_of_a_forward():
    port, _ = _pair()
    images, clicks, _ = _batch(SMALL, n=3)
    with profiling.record_spans() as log, torch.no_grad():
        port(images, clicks)
    assert [s.name for s in log.spans] == ["sam.image_encoder", "sam.prompt_encoder",
                                           "sam.mask_decoder"]
    # 2 windowed blocks and 1 global; a 4 x 4 grid padded to 6 x 6 is 20 tokens an image
    assert dict(log.counts) == {"sam.window_attention": 2, "sam.global_attention": 1,
                                "sam.window_pad_tokens": 2 * 3 * 20}


def test_count_adds_its_amount_and_nothing_when_off():
    profiling.count("x.off", 5)
    with profiling.record_spans() as log:
        profiling.count("x.n", 804)
        profiling.count("x.n")
    assert dict(log.counts) == {"x.n": 805}


def test_build_model_builds_sam_from_config():
    cfg = dataclasses.replace(config.CLIPUNET, name="sam", model="sam_vitb")
    model = config.build_model(cfg, "cpu", torch.Generator().manual_seed(0), sam=SMALL)
    assert isinstance(model, S.SamViTB) and config.MODELS["sam_vitb"][0] is S.SamViTB
    assert not model.training
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_window_partition_round_trips():
    x = torch.randn(2, 5, 7, 4)
    win, pad = S.window_partition(x, 3)
    assert win.shape == (2 * 2 * 3, 3, 3, 4) and pad == (6, 9)
    assert torch.equal(win[-1, -1, -1], torch.zeros(4))  # the padded corner
    assert torch.equal(S.window_unpartition(win, 3, pad, (5, 7)), x)


# -- ResidentTrainSet -------------------------------------------------------------

class _ResidentTrainSetBefore:
    """ResidentTrainSet as it was before it took uint8 sets and prompts."""

    def __init__(self, images, labels, device, quantize, heatmaps=None):
        from image_segmentation_tpu_torch.train.steps import labels_u8, quantize_u8

        self.quantize = quantize
        if quantize:
            images = quantize_u8(images)
            heatmaps = None if heatmaps is None else quantize_u8(heatmaps)
            labels = None if labels is None else labels_u8(labels)
        upload = lambda a: (None if a is None  # noqa: E731
                            else torch.from_numpy(np.ascontiguousarray(a)).to(device))
        self.images, self.heatmaps, self.labels = upload(images), upload(heatmaps), upload(labels)

    def _gather(self, a, idx):
        x = a.index_select(0, idx)
        return x.float() * (1.0 / 255.0) if self.quantize else x

    def batch(self, idx):
        x = self._gather(self.images, idx)
        heat = None if self.heatmaps is None else self._gather(self.heatmaps, idx)
        if self.labels is None:
            return x, x
        lab = self.labels.index_select(0, idx).long()
        return (x if heat is None else (x, heat)), lab


def _flat(batch):
    out = []
    for t in batch:
        out.extend(_flat(t) if isinstance(t, tuple) else [t])
    return out


@pytest.mark.parametrize("route", ["unet64_float32", "unet64_uint8", "heatmap_float32",
                                   "heatmap_uint8", "reconstruction_uint8"])
def test_resident_set_routes_gather_as_before(route):
    rng = np.random.default_rng(0)
    images = rng.random((10, 8, 8, 3), dtype=np.float32)
    labels = rng.integers(0, 4, (10, 8, 8)).astype(np.int32)
    heat = rng.random((10, 8, 8, 1), dtype=np.float32) if "heatmap" in route else None
    if route.startswith("reconstruction"):
        labels = None
    quantize = route.endswith("uint8")
    new = ResidentTrainSet(images, labels, "cpu", quantize, heatmaps=heat)
    old = _ResidentTrainSetBefore(images, labels, "cpu", quantize, heatmaps=heat)
    idx = torch.tensor([3, 0, 9, 3])
    got, want = _flat(new.batch(idx)), _flat(old.batch(idx))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_uint8_set_keeps_its_clicks_unrounded(kind):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (6, 8, 8, 3)).astype(np.uint8)
    labels = rng.integers(0, 4, (6, 8, 8)).astype(np.uint8)
    clicks = np.concatenate([rng.random((6, 1, 2)) * 7.3, np.ones((6, 1, 1))],
                            axis=-1).astype(np.float32)
    if kind == "tensor":
        images, labels, clicks = (torch.from_numpy(a) for a in (images, labels, clicks))
    data = ResidentTrainSet(images, labels, "cpu", quantize=False, prompts=clicks)
    assert data.quantize and data.images.dtype == torch.uint8
    idx = torch.tensor([5, 1, 2])
    (x, c), y = data.batch(idx)
    want_c = torch.as_tensor(np.asarray(clicks))[idx]
    assert c.dtype == torch.float32 and torch.equal(c, want_c)
    assert torch.equal(x, torch.as_tensor(np.asarray(images))[idx].float() * (1.0 / 255.0))
    assert y.dtype == torch.int64
    with pytest.raises(ValueError, match="not both"):
        ResidentTrainSet(images, labels, "cpu", True, heatmaps=images, prompts=clicks)


# -- CUDA graphs of a model with two outputs ----------------------------------------

class _PythonGraph:
    def __init__(self, work):
        self.work = work

    def replay(self):
        self.work()


def test_replay_of_two_outputs_hands_both_gradients():
    """A GraphPair whose forward returns (y, y.sum(1)), its graphs written
    out in Python as a capture would record them: the replayed step's
    gradients are the eager step's, through both outputs."""
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 4)
    eager = copy.deepcopy(model)
    x, y, ysum = torch.zeros(2, 3), torch.zeros(2, 4), torch.zeros(2)
    g_y, g_sum = torch.zeros(2, 4), torch.zeros(2)
    w, b = model.weight, model.bias
    bufs = [torch.zeros_like(w), torch.zeros_like(b)]

    def fwd():
        with torch.no_grad():
            y.copy_(x @ w.T + b)
            ysum.copy_(y.sum(1))

    def bwd():
        g = g_y + g_sum[:, None]
        bufs[0].add_(g.T @ x)
        bufs[1].add_(g.sum(0))

    pair = G.GraphPair(G._input_key((x,)), (x,), _PythonGraph(fwd), _PythonGraph(bwd),
                       (y, ysum), (g_y, g_sum), [w, b], bufs, [])
    xs = [torch.randn(2, 3) for _ in range(2)]
    pair.begin_step()
    for xi in xs:
        out, total = pair.forward(model, (xi,))
        (out.square().sum() + 3 * total.sum()).backward()
    pair.hand_grads()
    for xi in xs:
        out = eager(xi)
        (out.square().sum() + 3 * out.sum(1).sum()).backward()
    torch.testing.assert_close(model.weight.grad, eager.weight.grad)
    torch.testing.assert_close(model.bias.grad, eager.bias.grad)
    assert G._outputs((torch.zeros(1),)) is None  # no gradient: eager
    assert (K5, "LAUNCHES") in G._launch_counters()


# -- the benchmark cell at CPU size -------------------------------------------------

TINY = {"image_size": 64, "vit_patch_size": 16, "image_embedding_size": 4,
        "encoder_embed_dim": 32, "encoder_depth": 3, "encoder_num_heads": 2,
        "encoder_mlp_dim": 128, "encoder_global_attn_indexes": [1], "window_size": 3,
        "prompt_embed_dim": 32, "num_pos_feats": 16, "decoder_num_heads": 2,
        "decoder_mlp_dim": 64, "iou_head_hidden_dim": 32}
TINY_TRAFFIC = {"set_size": 12, "micro_batch": 2, "accum_steps": 2, "warmup_steps": 1,
                "trace_steps": 2}


def _tiny_cell():
    from perfbench import harness

    cell = copy.copy(harness.load_cell("sam_vitb_train_clicks_b64"))
    cell.cfg = dict(cell.cfg, **TINY)
    cell.traffic = dict(cell.traffic, **TINY_TRAFFIC)
    return cell


def test_benchmark_cell_is_declared_and_counts_at_full_size():
    from perfbench import harness

    bench = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.load_cell("sam_vitb_train_clicks_b64")
    assert cell.chips == 1 and cell.traffic["kind"] == "train_clicks"
    assert {m["name"] for m in cell.per_layer} >= {"k5_roofline.train", "k5_device_ms.train",
                                                   "train_mfu"}
    conf = next(c for c in bench["configs"] if c["name"] == "sam_vitb")
    assert conf["reduced"] == [] and cell.cfg["parameters"] == 93_730_788
    b = cell.builder
    ref = b.reference(cell.cfg)
    assert sum(p.numel() for p in ref.parameters()) == cell.cfg["parameters"]
    assert sum(p.numel() for n, p in ref.named_parameters()
               if n.startswith("image_encoder.")) == cell.cfg["image_encoder_parameters"]
    calls = b.k5_calls(cell.cfg, 8)
    assert calls.count((200, 196, 12, 64, 14, 14)) == 8 and calls.count(
        (8, 4096, 12, 64, 64, 64)) == 4
    flops, nbytes = b.k5_counts(8, 4096, 12, 64, 64, 64)  # the terms made in the kernel
    assert flops == 4 * 8 * 12 * 4096 ** 2 * 64 + 2 * 8 * 12 * 4096 * 128 * 64
    assert nbytes == 2 * (4 * 8 * 4096 * 768 + 254 * 64)
    flops, nbytes = b.k5_counts(200, 196, 12, 64, 14, 14)
    assert flops == 4 * 200 * 12 * 196 ** 2 * 64 + 2 * 200 * 12 * 196 * 28 * 64
    assert nbytes == 2 * (4 * 200 * 196 * 768 + 54 * 64)
    assert 960e9 < b.encoder_flops(cell.cfg) < 985e9
    assert 0.98 < b.encoder_flops(cell.cfg) / b.train_flops(cell.cfg) < 1.0
    for m in ("k5_roofline.train", "k5_device_ms.train"):
        from perfbench.tracing import Reading, Spans

        assert harness.metric_reader(m)(Reading(Spans(False), None, {})) is None


def test_benchmark_set_is_pet_like_and_its_clicks_land_on_the_pet():
    from perfbench.kinds import train_clicks

    cell = _tiny_cell()
    images, labels, clicks = train_clicks.make_set(cell.cfg, cell.traffic, 2**31 + 11, "cpu")
    again = train_clicks.make_set(cell.cfg, cell.traffic, 2**31 + 11, "cpu")
    assert all(torch.equal(a, b) for a, b in zip((images, labels, clicks), again))
    assert images.dtype == labels.dtype == torch.uint8 and clicks.dtype == torch.float32
    assert set(labels.unique().tolist()) <= {0, 1, 2, 3}
    x, y = clicks[:, 0, 0].long(), clicks[:, 0, 1].long()
    at = labels[torch.arange(len(labels)), y, x]
    assert ((at == 1) | (at == 2)).all() and (clicks[:, 0, 2] == 1).all()


def test_benchmark_kind_runs_correct_on_the_cpu():
    """The cell's kind at CPU size: set-up, the checked steps through
    `train_step`, a short window, and the check against the reference in
    float32 on both sides, which passes with room; both sides pick the same
    mask for every image."""
    cell = _tiny_cell()
    outcome = cell.kind.run(cell, 12345, 0.3, False, "cpu", time.perf_counter())
    assert outcome.attempted >= 1 and outcome.e2e["train_images_per_s"] > 0
    checks = {c.name: c for c in outcome.checks}
    assert set(checks) == {"loss_rms_rel", "grad1_median_rel", "change_rel", "grad1_diff_rel"}
    assert all(c.ok for c in checks.values()), outcome.checks
    assert checks["loss_rms_rel"].value < 1e-5 and checks["grad1_median_rel"].value < 1e-4
    assert checks["grad1_diff_rel"].value < 1e-4
    assert outcome.detail["choice_differs"] == 0 and outcome.detail["choice_images"] == 12
    assert outcome.detail["choice_followed"] == 0
    json.dumps(outcome.detail)


def test_benchmark_faults_are_caught():
    cell = _tiny_cell()
    for fault, failing in (("unchanged", "change_rel"), ("half_batch", "loss_rms_rel")):
        outcome = cell.kind.run(cell, 7, 0.1, False, "cpu", time.perf_counter(), fault=fault,
                                window=False)
        assert not {c.name: c for c in outcome.checks}[failing].ok, fault


def test_benchmark_reference_follows_only_near_tie_choices():
    """The reference backpropagates the other side's mask only where that
    mask's loss is within `TIE` of its lowest, and its own elsewhere."""
    from perfbench.kinds import train_clicks

    tie = train_clicks.TIE
    per_mask = torch.tensor([[1.0, 1.0 + tie / 2, 2.0], [1.0, 1.0 + 2 * tie, 3.0],
                             [2.0, 1.0, 1.0 + tie / 2], [1.0, 2.0, 3.0]])
    follow = torch.tensor([1, 1, 2, 0])
    assert train_clicks.tie_choice(per_mask, follow).tolist() == [1, 0, 2, 0]
    assert train_clicks.tie_choice(per_mask, None).tolist() == [0, 0, 1, 0]


def test_benchmark_reference_reports_its_lowest_loss_whatever_it_follows(monkeypatch):
    """Following another side's masks moves the reference's gradient and
    nothing it reports as its loss or its choice; masks outside the tie
    are not followed."""
    from perfbench.kinds import train_clicks

    cell = _tiny_cell()
    images, labels, clicks = train_clicks.make_set(cell.cfg, cell.traffic, 5, "cpu")
    data = ResidentTrainSet(images, labels, "cpu", quantize=True, prompts=clicks)
    own = train_clicks.reference(cell, 5, "cpu", data, 1)
    other = (own["choices"] + 1) % 3
    monkeypatch.setattr(train_clicks, "TIE", math.inf)
    followed = train_clicks.reference(cell, 5, "cpu", data, 1, follow=other)
    assert followed["losses"] == own["losses"]
    assert torch.equal(followed["choices"], own["choices"])
    assert followed["followed"] == other.numel() and own["followed"] == 0
    assert followed["grad"] != own["grad"]
    monkeypatch.setattr(train_clicks, "TIE", 0.0)
    refused = train_clicks.reference(cell, 5, "cpu", data, 1, follow=other)
    assert refused["followed"] == 0 and refused["grad"] == own["grad"]


def test_benchmark_check_reads_gradient_noise_that_norms_miss():
    """Noise of a tenth of each leaf's size leaves its norm within a
    percent or so, and moves the distance between the gradients by a tenth."""
    from perfbench.kinds import train_clicks

    g = torch.Generator().manual_seed(0)
    ref_t = {f"w{i}": torch.randn(4096, generator=g) * (i + 1) for i in range(5)}
    prog_t = {k: v + 0.1 * v.norm() / 64 * torch.randn(4096, generator=g)
              for k, v in ref_t.items()}
    norms = lambda t: {k: float(v.norm()) for k, v in t.items()}  # noqa: E731
    side = lambda t: {"losses": [[1.0]], "grad": norms(t), "grad_t": t,  # noqa: E731
                      "change": norms(t)}
    values = train_clicks.check(side(prog_t), side(ref_t))
    assert values["grad1_median_rel"] < 0.01
    assert 0.09 < values["grad1_diff_rel"] < 0.11
    assert train_clicks.check(side(ref_t), side(ref_t))["grad1_diff_rel"] == 0
