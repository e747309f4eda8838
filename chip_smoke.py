"""Smoke run of the PyTorch port's serving paths on one CUDA card.

Phases (each prints its lines; any failure ends the run non-zero):
  1. device: requires CUDA, prints the card's name and power limit and
     the TF32 settings;
  2. build: compiles the hand-written kernels from csrc/ with nvcc, one
     process per source, all started together;
  3. kernels: K3 (attention), K4 (MLP) and K1 (double conv) against
     their plain PyTorch versions in bf16 at every shape the serving
     paths give them, with median times (K1 also beside the same double
     conv through cuDNN): K3 and K4 at batch 1, 2, 4 and 8; K1 at the nine
     levels of the unet family (256 px) and of the prompt model's
     selection UNet (224 px, a Cin = 4 stem), each at N = 1, 2, 4 and 8;
  4. serving, clip family: a full-width ClipUNet (ViT-B/16 widths, seeded
     random weights, bf16, kernels on) registered in the port's
     InferenceEngine serves host images of several sizes; the launch
     counters must show 12 launches of K3 and K4 per request; the same
     requests through the plain versions must agree;
  5. serving, unet family: a full-width UNet (base 64, 256 px, seeded
     random weights and BN statistics, bf16, K1 on), registered as
     `unet` beside `clip` in the same engine, serves the same images
     with 9 K1 launches per request; the same requests through the
     module path (cuDNN, bf16) must agree;
  6. four families: one engine serves unet, autoencoder, clip and the
     composed prompt_model at full width (seeded random weights, BN
     perturbed). An interactive session of 8 clicks on one image must
     launch K3/K4/K1 12/12/9 times on the first click and 0/0/9 on each
     later one (7 cache hits); the composed prompt path must agree with
     the PromptModel forward within one bf16 step, and on at least 0.9 of
     the argmax with a PromptModel on the plain versions; one request of
     each family at each image size;
  7. batched mixed load: a BatchingEngine (max_batch 8, 3 ms window) on
     the same engine takes 64 requests from 16 client threads over the
     four families (distinct images, a fixed box prompt); every mask
     agrees with the same request served alone on at least 0.99 of its
     pixels, some batch holds more than one request, and the launches
     match the dispatched batches. Prints requests/s, each family's
     single-stream p50 and the peak device memory;
  8. the last line is {"ok": true, "device": {...}}.

The launch counts of phases 4-7 are each set to 0 just before the path
is driven and read just after; the kernels line sums them.

Run from the repository root: python3 chip_smoke.py
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Two bf16 steps at the output's largest magnitude: kernel and plain
# version round at the same points but sum in another order, so an
# output (or an intermediate it depends on) can land one step apart.
REL_TOL = 2.0**-6
TOL_REASON = ("2 bf16 steps (2^-6 x max|plain|): same cast points, "
              "f32 sums in another order")


def _cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _compare(name, got, want):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs().max().item()
    tol = REL_TOL * want.abs().max().item()
    print(f"[kernels] {name}: max_abs_err={err} tol={tol} ({TOL_REASON})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > tol {tol}")
    return err


def phase_kernels(A, M, card: str) -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    res = {}

    # K3 and K4 at every batch the serving paths give them (BatchingEngine
    # buckets 1, 2, 4, 8), then a ragged case.
    errs = []
    for shape, v_offset in [((b, 197, 12, 64), 0.0) for b in BATCHES] + [((1, 130, 2, 64), 10.0)]:
        q, k = rnd(*shape).bfloat16(), rnd(*shape).bfloat16()
        v = (rnd(*shape) + v_offset).bfloat16()
        got = A.fused_attention(q, k, v)
        torch.cuda.synchronize()
        errs.append(_compare(f"attention {shape} v+{v_offset}", got,
                             A.attention_reference(q, k, v)))
        ms = _cuda_ms(lambda: A.fused_attention(q, k, v))
        plain_ms = _cuda_ms(lambda: A.attention_reference(q, k, v))
        print(f"[kernels] attention {shape}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (median of 20, warm L2; {card})")
        if shape == (1, 197, 12, 64):
            res["fused_attention"] = {"ms": ms, "plain_ms": plain_ms}
    res["fused_attention"]["max_abs_err"] = max(errs)

    errs = []
    for m in [b * 197 for b in BATCHES] + [333]:
        x = (0.5 * rnd(1, m, 768)).bfloat16()
        ln_w, ln_b = 1.0 + 0.1 * rnd(768), 0.1 * rnd(768)
        w1, b1 = (0.03 * rnd(3072, 768)).bfloat16(), 0.1 * rnd(3072)
        w2, b2 = (0.03 * rnd(768, 3072)).bfloat16(), 0.1 * rnd(768)
        args = (x, ln_w, ln_b, w1, b1, w2, b2, 1e-5)
        got = M.fused_mlp(*args)
        torch.cuda.synchronize()
        errs.append(_compare(f"mlp tokens={m} 768->3072->768", got, M.mlp_reference(*args)))
        ms = _cuda_ms(lambda: M.fused_mlp(*args))
        plain_ms = _cuda_ms(lambda: M.mlp_reference(*args))
        print(f"[kernels] mlp tokens={m}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (median of 20, warm L2; {card})")
        if m == 197:
            res["fused_mlp"] = {"ms": ms, "plain_ms": plain_ms}
    res["fused_mlp"]["max_abs_err"] = max(errs)
    res["fused_double_conv"] = phase_double_conv(card)
    return res


# The batch sizes the serving paths run: one request, and the
# BatchingEngine's buckets at max_batch 8.
BATCHES = (1, 2, 4, 8)


def unet64_levels(side: int, cin: int):
    """The nine double convs of one UNet-64 forward at `side` px, in order
    (stem, down 2-5, up 1-4), as (side, Cin, Cout)."""
    return ((side, cin, 64), (side // 2, 64, 128), (side // 4, 128, 256),
            (side // 8, 256, 512), (side // 16, 512, 1024), (side // 8, 1024, 512),
            (side // 4, 512, 256), (side // 2, 256, 128), (side, 128, 64))


UNET64_CASES = [((1, h, h, cin), c, 0.0) for h, cin, c in unet64_levels(256, 3)]
# K1 at every shape the served paths give it: the unet family at 256 px and
# the prompt model's selection UNet at 224 px (a Cin = 4 stem, a ragged 14²
# deepest level), each at every batch size; then a ragged shape with
# bias1 = +1.
K1_CASES = [((n, h, h, cin), c, 0.0) for n in BATCHES
            for side, cin0 in ((256, 3), (224, 4))
            for h, cin, c in unet64_levels(side, cin0)] + [((1, 37, 45, 24), 72, 1.0)]


def phase_double_conv(card: str) -> dict:
    from torch import nn

    from image_segmentation_tpu_torch.models.layers import ConvBNRelu
    from image_segmentation_tpu_torch.ops.kernels import double_conv as D

    g = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    errs, total = [], {"ms": 0.0, "plain_ms": 0.0, "cudnn_ms": 0.0}
    for xshape, c, b1_offset in K1_CASES:
        cin = xshape[-1]
        x = rnd(*xshape).bfloat16()
        w1 = (rnd(3, 3, cin, c) * (2 / (9 * cin)) ** 0.5).bfloat16()
        w2 = (rnd(3, 3, c, c) * (2 / (9 * c)) ** 0.5).bfloat16()
        args = (x, w1, 1 + 0.1 * rnd(c), 0.1 * rnd(c) + b1_offset, w2,
                1 + 0.1 * rnd(c), 0.1 * rnd(c))
        got = D.fused_double_conv(*args)
        torch.cuda.synchronize()
        name = f"double_conv {xshape}->{c} bias1+{b1_offset}"
        errs.append(_compare(name, got, D.double_conv_reference(*args)))
        ms = _cuda_ms(lambda: D.fused_double_conv(*args))
        plain_ms = _cuda_ms(lambda: D.double_conv_reference(*args))
        # the module path's double conv: cuDNN conv, BN, ReLU, twice, bf16
        cudnn = nn.Sequential(ConvBNRelu(cin, c), ConvBNRelu(c, c)).to(
            device="cuda", memory_format=torch.channels_last).eval()
        xc = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            cudnn_ms = _cuda_ms(lambda: cudnn(xc))
        print(f"[kernels] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"cuDNN ConvBNRelu x2 bf16 {cudnn_ms:.4f} ms (median of 20, warm L2; {card})")
        if (xshape, c, b1_offset) in UNET64_CASES:
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("cudnn_ms", cudnn_ms)):
                total[key] += v
    print(f"[kernels] double_conv, the nine UNet-64 levels of one request summed: "
          f"kernel {total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, "
          f"cuDNN {total['cudnn_ms']:.4f} ms ({card})")
    return {"ms": total["ms"], "plain_ms": total["plain_ms"], "max_abs_err": max(errs)}


def _images():
    rng = np.random.default_rng(0)
    sizes = ((375, 500), (224, 224), (512, 333), (400, 1))
    return [rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32) for h, w in sizes]


def phase_serving(A, M, card: str):
    from image_segmentation_tpu_torch.config import CLIPUNET, build_model
    from image_segmentation_tpu_torch.serve.engine import InferenceEngine, stage_request

    t0 = time.time()
    model = build_model(CLIPUNET, "cuda", torch.Generator().manual_seed(0))
    plain = build_model(dataclasses.replace(CLIPUNET, use_kernels=False), "cuda",
                        torch.Generator().manual_seed(0))
    print(f"[serve] built full-width ClipUNet twice (kernels / plain, same seed) "
          f"in {time.time() - t0:.1f} s; "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"compute {model.dtype}")
    eng = InferenceEngine(device="cuda")
    eng.register("clip", model, CLIPUNET.target_size)
    eng.register("clip_plain", plain, CLIPUNET.target_size)
    images = _images()
    n_layers = model.vit.num_layers

    eng.segment(images[1], "clip")  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # The main path: counters from 0, one segment() per image.
    A.LAUNCHES = M.LAUNCHES = 0
    for img in images:
        before = (A.LAUNCHES, M.LAUNCHES)
        t = time.perf_counter()
        out = eng.segment(img, "clip")
        dt = (time.perf_counter() - t) * 1e3
        delta = (A.LAUNCHES - before[0], M.LAUNCHES - before[1])
        mask = out["mask"]
        print(f"[serve] {img.shape[:2]} -> mask {mask.shape} classes "
              f"{np.bincount(mask.ravel(), minlength=4).tolist()} "
              f"launches (attention, mlp) +{delta} in {dt:.2f} ms")
        if mask.shape != img.shape[:2]:
            raise AssertionError(f"mask {mask.shape} for image {img.shape[:2]}")
        if mask.max() > 3:
            raise AssertionError(f"class id {mask.max()} outside 0..3")
        if delta != (n_layers, n_layers):
            raise AssertionError(f"kernel launches {delta}, want {n_layers} each")
    launches = {"fused_attention": A.LAUNCHES, "fused_mlp": M.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] launches over {len(images)} requests: {launches}; "
          f"peak device memory {peak} bytes ({card})")

    # The same requests through the plain versions (bf16 scores both ways).
    agree = total = 0
    max_diff = 0.0
    for img in images:
        (staged,), _ = stage_request(img, eng.models["clip"], None, eng.fast_transfer)
        s_k = eng.forward("clip", staged[None])[0]
        s_p = eng.forward("clip_plain", staged[None])[0]
        if s_k.shape != (224, 224, 4) or not np.isfinite(s_k).all():
            raise AssertionError(f"scores {s_k.shape} finite={np.isfinite(s_k).all()}")
        max_diff = max(max_diff, float(np.abs(s_k - s_p).max()))
        agree += int((s_k.argmax(-1) == s_p.argmax(-1)).sum())
        total += s_k.shape[0] * s_k.shape[1]
    share = agree / total
    print(f"[serve] kernels vs plain versions, bf16 scores: max_abs_diff={max_diff} "
          f"argmax agreement {share:.6f} of {total} pixels")
    if share < 0.9:
        raise AssertionError(f"argmax agreement {share} < 0.9 between kernel and plain paths")

    lat = []
    for _ in range(10):
        t = time.perf_counter()
        eng.segment(images[0], "clip")
        lat.append((time.perf_counter() - t) * 1e3)
    (staged,), _ = stage_request(images[0], eng.models["clip"], None, eng.fast_transfer)
    x = torch.from_numpy(staged[None]).cuda().float() / 255.0
    with torch.inference_mode():
        fwd_ms = _cuda_ms(lambda: model(x), iters=10)
        plain_fwd_ms = _cuda_ms(lambda: plain(x), iters=10)
    print(f"[serve] segment() 375x500 latency after warm-up: median "
          f"{statistics.median(lat):.3f} ms, min {min(lat):.3f} ms (10 requests, host clock); "
          f"model forward {fwd_ms:.3f} ms with kernels, {plain_fwd_ms:.3f} ms plain "
          f"(CUDA events); {card}")
    return launches, eng, model


def _perturb_batchnorm_(model: torch.nn.Module, seed: int) -> None:
    """Move every BN's statistics and affine parameters off 0 and 1, from a
    seed, so that the kernel path's BN folding is exercised."""
    from image_segmentation_tpu_torch.models.layers import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.weight.numel()
                for t, new in ((m.running_mean, 0.1 * torch.randn(c, generator=g)),
                               (m.running_var, 0.5 + torch.rand(c, generator=g)),
                               (m.weight, 1 + 0.1 * torch.randn(c, generator=g)),
                               (m.bias, 0.1 * torch.randn(c, generator=g))):
                    t.copy_(new)


def phase_unet(eng, card: str) -> int:
    """The unet family registered beside the clip family in the same engine."""
    from image_segmentation_tpu_torch.config import UNET_NOAUG, build_model
    from image_segmentation_tpu_torch.ops.kernels import double_conv as D
    from image_segmentation_tpu_torch.serve.engine import stage_request

    t0 = time.time()
    model = build_model(UNET_NOAUG, "cuda", torch.Generator().manual_seed(0))
    plain = build_model(dataclasses.replace(UNET_NOAUG, use_kernels=False), "cuda",
                        torch.Generator().manual_seed(0))
    _perturb_batchnorm_(model, 1)
    _perturb_batchnorm_(plain, 1)
    size = UNET_NOAUG.target_size
    print(f"[unet] built full-width UNet twice (K1 / module path, same seed) in "
          f"{time.time() - t0:.1f} s; {sum(p.numel() for p in model.parameters())} "
          f"parameters, compute {model.dtype}, {size} px")
    eng.register("unet", model, size)
    eng.register("unet_plain", plain, size)
    print(f"[unet] registry: {eng.available()}")
    images = _images()

    eng.segment(images[1], "unet")  # warm-up (cuDNN plans, allocator)
    eng.segment(images[1], "unet_plain")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()

    # The main path: the counter from 0, one segment() per image.
    D.LAUNCHES = 0
    for img in images:
        before = D.LAUNCHES
        t = time.perf_counter()
        out = eng.segment(img, "unet")
        dt = (time.perf_counter() - t) * 1e3
        delta = D.LAUNCHES - before
        mask = out["mask"]
        print(f"[unet] {img.shape[:2]} -> mask {mask.shape} classes "
              f"{np.bincount(mask.ravel(), minlength=4).tolist()} "
              f"double_conv launches +{delta} in {dt:.2f} ms")
        if mask.shape != img.shape[:2]:
            raise AssertionError(f"mask {mask.shape} for image {img.shape[:2]}")
        if mask.max() > 3:
            raise AssertionError(f"class id {mask.max()} outside 0..3")
        if delta != 9:
            raise AssertionError(f"double_conv launches {delta} per request, want 9")
    launches = D.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    print(f"[unet] double_conv launches over {len(images)} requests: {launches}; "
          f"peak device memory {peak} bytes, of which {resident} resident before the "
          f"requests (both families' models, kernel and plain) ({card})")

    # The same requests through the module path (bf16 scores both ways).
    agree = total = 0
    max_diff = 0.0
    for img in images:
        (staged,), _ = stage_request(img, eng.models["unet"], None, eng.fast_transfer)
        s_k = eng.forward("unet", staged[None])[0]
        s_p = eng.forward("unet_plain", staged[None])[0]
        if s_k.shape != (size, size, 4) or not np.isfinite(s_k).all():
            raise AssertionError(f"scores {s_k.shape} finite={np.isfinite(s_k).all()}")
        max_diff = max(max_diff, float(np.abs(s_k - s_p).max()))
        agree += int((s_k.argmax(-1) == s_p.argmax(-1)).sum())
        total += s_k.shape[0] * s_k.shape[1]
    share = agree / total
    print(f"[unet] K1 path vs module path, bf16 scores: max_abs_diff={max_diff} "
          f"argmax agreement {share:.6f} of {total} pixels")
    if share < 0.9:
        raise AssertionError(f"argmax agreement {share} < 0.9 between K1 and module paths")

    lat = []
    for _ in range(10):
        t = time.perf_counter()
        eng.segment(images[0], "unet")
        lat.append((time.perf_counter() - t) * 1e3)
    (staged,), _ = stage_request(images[0], eng.models["unet"], None, eng.fast_transfer)
    x = torch.from_numpy(staged[None]).cuda().float() / 255.0
    with torch.inference_mode():
        fwd_ms = _cuda_ms(lambda: model(x), iters=10)
        plain_fwd_ms = _cuda_ms(lambda: plain(x), iters=10)
    print(f"[unet] segment() 375x500 latency after warm-up: median "
          f"{statistics.median(lat):.3f} ms, min {min(lat):.3f} ms (10 requests, host clock); "
          f"model forward {fwd_ms:.3f} ms with K1, {plain_fwd_ms:.3f} ms module path "
          f"(CUDA events); {card}")
    return launches, model


KERNEL_NAMES = ("fused_attention", "fused_mlp", "fused_double_conv")


def _counts(K) -> tuple:
    return tuple(k.LAUNCHES for k in K)


def _zero(K) -> None:
    for k in K:
        k.LAUNCHES = 0


def _add(launches: dict, K) -> None:
    """Add the counts of the path just driven to the totals."""
    for name, n in zip(KERNEL_NAMES, _counts(K)):
        launches[name] += n


def _check_mask(name, mask, hw):
    if mask.shape != hw:
        raise AssertionError(f"{name}: mask {mask.shape} for image {hw}")
    if mask.max() > 3:
        raise AssertionError(f"{name}: class id {mask.max()} outside 0..3")


def phase_four_families(K, clip, unet, launches: dict, card: str):
    """One engine with the four families at full width, the prompt family
    composed: an interactive session, composed against monolithic and
    against the plain versions, and one request of each family at each
    image size."""
    from image_segmentation_tpu_torch.config import AUTOENCODER, PROMPT, build_model
    from image_segmentation_tpu_torch.serve.app import register_families
    from image_segmentation_tpu_torch.serve.engine import InferenceEngine, stage_request
    from image_segmentation_tpu_torch.serve.render import render_points

    t0 = time.time()
    ae = build_model(AUTOENCODER, "cuda", torch.Generator().manual_seed(0))
    prompt = build_model(PROMPT, "cuda", torch.Generator().manual_seed(0))
    _perturb_batchnorm_(ae, 2)
    _perturb_batchnorm_(prompt, 3)
    n_params = lambda m: sum(p.numel() for p in m.parameters())
    print(f"[families] built full-width autoencoder (base 64, {n_params(ae)} parameters) and "
          f"prompt model (ViT-B/16 clip branch + base-64 4-channel mask UNet, "
          f"{n_params(prompt)} parameters) in {time.time() - t0:.1f} s; compute {prompt.dtype} "
          f"({card})")
    eng = InferenceEngine(device="cuda")
    register_families(eng, [("unet", unet, 256, False), ("autoencoder", ae, 256, False),
                            ("clip", clip, 224, False), ("prompt_model", prompt, 224, True)])
    cache = eng.models["prompt_model"].score_cache
    if cache is None:
        raise AssertionError("prompt_model is not composed")
    print(f"[families] registry: {eng.available()}, prompt_model composed "
          f"(score cache capacity {cache.capacity})")
    images = _images()
    for name in eng.available():  # warm-up (cuDNN plans, allocator), another image
        eng.segment(images[1], name, np.zeros(images[1].shape[:2], np.float32))
    torch.cuda.synchronize()

    # The interactive session: one 375x500 image, 8 clicks at distinct points.
    img = images[0]
    clicks = [{"x": 40 + 60 * i, "y": 330 - 40 * i} for i in range(8)]
    n = prompt.clip.vit.num_layers
    hits0, deltas, lat = cache.hits, [], []
    _zero(K)
    for click in clicks:
        before = _counts(K)
        t = time.perf_counter()
        out = eng.segment(img, "prompt_model", render_points([click], img.shape[:2]))
        lat.append((time.perf_counter() - t) * 1e3)
        deltas.append(tuple(a - b for a, b in zip(_counts(K), before)))
        _check_mask("prompt_model", out["mask"], img.shape[:2])
    _add(launches, K)
    hits = cache.hits - hits0
    print(f"[families] interactive session, 8 clicks on one 375x500 image: launches "
          f"(attention, mlp, double_conv) per click {deltas}; cache hits {hits}")
    print(f"[families] click latency (host clock, segment()): cold {lat[0]:.3f} ms, warm "
          f"median {statistics.median(lat[1:]):.3f} ms, min {min(lat[1:]):.3f} ms ({card})")
    if deltas[0] != (n, n, 9) or any(d != (0, 0, 9) for d in deltas[1:]) or hits != 7:
        raise AssertionError(f"click launches {deltas}, hits {hits}: want ({n}, {n}, 9) "
                             f"then (0, 0, 9) with 7 hits")

    # The same request through the PromptModel forward itself.
    hm = render_points([clicks[0]], img.shape[:2])
    inputs, _ = stage_request(img, eng.models["prompt_model"], hm, eng.fast_transfer)
    composed = eng.forward("prompt_model", *(a[None] for a in inputs))[0]
    with torch.inference_mode():
        x, h = (torch.from_numpy(a[None]).cuda().float() / 255.0 for a in inputs)
        mono = prompt(x, h)[0].float().cpu().numpy()
    t = eng.models["prompt_model"].target_size
    if not np.isfinite(composed).all() or composed.shape != (t, t, 4):
        raise AssertionError(f"composed scores {composed.shape} not finite or misshaped")
    err = float(np.abs(composed - mono).max())
    agree = float((composed.argmax(-1) == mono.argmax(-1)).mean())
    print(f"[families] composed (bf16 transfer) vs PromptModel forward (f32 out): "
          f"max_abs_diff={err} (tol 2^-8, one bf16 step on [0, 1]); argmax agreement "
          f"{agree:.6f} of {t * t} pixels")
    if not err <= 2.0**-8:
        raise AssertionError(f"composed vs monolithic differ by {err} > 2^-8")

    # The same request through the plain versions: a PromptModel with the
    # same weights, its clip branch on the plain attention and MLP, its
    # selection UNet on the module path (cuDNN), bf16 as well.
    plain = build_model(dataclasses.replace(PROMPT, use_kernels=False), "cuda",
                        torch.Generator().manual_seed(0))
    _perturb_batchnorm_(plain, 3)
    with torch.inference_mode():
        s_p = plain(x, h)[0].float().cpu().numpy()
    del plain
    err = float(np.abs(composed - s_p).max())
    agree = float((composed.argmax(-1) == s_p.argmax(-1)).mean())
    print(f"[families] composed (kernels) vs PromptModel forward through the plain "
          f"versions: max_abs_diff={err}; argmax agreement {agree:.6f} of {t * t} pixels")
    if agree < 0.9:
        raise AssertionError(f"argmax agreement {agree} < 0.9 between the composed "
                             f"kernel path and the plain versions")

    # One request of each family at each image size.
    _zero(K)
    for name in eng.available():
        for im in images:
            pm = (render_points([{"x": im.shape[1] // 2, "y": im.shape[0] // 2}], im.shape[:2])
                  if name == "prompt_model" else None)
            out = eng.segment(im, name, pm)
            _check_mask(name, out["mask"], im.shape[:2])
        print(f"[families] {name}: {[im.shape[:2] for im in images]} -> masks at the "
              f"images' sizes, class ids <= 3")
    _add(launches, K)
    return eng


def phase_batched(K, eng, n_layers: int, launches: dict, card: str) -> None:
    """64 requests from 16 client threads over the four families through a
    BatchingEngine on the four-family engine."""
    import concurrent.futures

    from image_segmentation_tpu_torch.serve.batching import BatchingEngine
    from image_segmentation_tpu_torch.serve.profiling import MixedLoad

    be = BatchingEngine(eng, max_batch=8, max_wait_ms=3)
    try:
        t0 = time.time()
        be.warmup()
        print(f"[batched] warm-up of buckets 1, 2, 4, 8 of the four families took "
              f"{time.time() - t0:.2f} s ({card})")
        names = eng.available()
        load = MixedLoad(names, 64)  # a distinct 300x400 image per request, a fixed box
        prompt_of = lambda name: load.box if name == "prompt_model" else None
        cache = eng.models["prompt_model"].score_cache

        batches = {name: [] for name in names}
        originals = {name: eng.models[name].dispatch for name in names}
        for name in names:
            def counted(*inputs, _name=name, _dispatch=originals[name]):
                batches[_name].append(inputs[0].shape[0])
                return _dispatch(*inputs)
            eng.models[name].dispatch = counted

        def one(i):
            return be.segment(*load.request(i), timeout=300)["mask"]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        misses0 = cache.misses
        _zero(K)
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            t = time.perf_counter()
            masks = list(ex.map(one, load.take(64)))
            wall = time.perf_counter() - t
        counts = _counts(K)
        _add(launches, K)
        peak = torch.cuda.max_memory_allocated()
        misses = cache.misses - misses0
        for name in names:
            eng.models[name].dispatch = originals[name]
        sizes = [b for name in names for b in batches[name]]
        hist = {b: sizes.count(b) for b in sorted(set(sizes))}
        print(f"[batched] 64 requests, 16 clients, 4 families: {64 / wall:.3f} requests/s "
              f"({wall * 1e3:.1f} ms wall); batches per family "
              f"{ {k: len(v) for k, v in batches.items()} }; histogram of padded batch sizes "
              f"{hist}; "
              f"peak device memory {peak} bytes ({card})")
        if max(sizes) < 2:
            raise AssertionError(f"no batch held more than one request: {hist}")
        clip_forwards = len(batches["clip"]) + misses
        want = (n_layers * clip_forwards, n_layers * clip_forwards,
                9 * (len(batches["unet"]) + len(batches["prompt_model"])))
        print(f"[batched] launches (attention, mlp, double_conv) {counts}; want {want} from "
              f"{len(batches['clip'])} clip batches, {misses} prompt cache misses, "
              f"{len(batches['unet'])} unet and {len(batches['prompt_model'])} prompt batches")
        if counts != want:
            raise AssertionError(f"launches {counts} do not match the batches: want {want}")

        # Every mask against the same request served alone.
        agree = []
        for i, mask in enumerate(masks):
            image, name, prompt = load.request(i)
            want_mask = eng.segment(image, name, prompt)["mask"]
            _check_mask(name, mask, image.shape[:2])
            agree.append(float((mask == want_mask).mean()))
        low = int(np.argmin(agree))
        print(f"[batched] agreement with segment() alone: lowest {agree[low]:.6f} "
              f"({names[low % 4]}, request {low}), mean {statistics.mean(agree):.6f}")
        if agree[low] < 0.99:
            raise AssertionError(f"request {low} agrees with segment() on {agree[low]} < 0.99")

        p50 = {}
        for k, name in enumerate(names):
            lat = []
            for i in range(8):
                t = time.perf_counter()
                be.segment(load.images[8 * k + i], name, prompt_of(name))
                lat.append((time.perf_counter() - t) * 1e3)
            p50[name] = round(statistics.median(lat), 3)
        print(f"[batched] single-stream p50 over 8 distinct images through the "
              f"BatchingEngine, ms: {p50} ({card})")
    finally:
        be.close()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from image_segmentation_tpu_torch.ops.kernels import _build
    from image_segmentation_tpu_torch.ops.kernels import attention as A
    from image_segmentation_tpu_torch.ops.kernels import double_conv as D
    from image_segmentation_tpu_torch.ops.kernels import mlp as M

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    start = t0 = time.time()
    _build.build()
    _build.load()
    print(f"[build] nvcc built {_build.LIB_PATH} from {_build.SOURCES} "
          f"in {time.time() - t0:.2f} s")

    timing = phase_kernels(A, M, card)
    launches, eng, clip = phase_serving(A, M, card)
    launches["fused_double_conv"], unet = phase_unet(eng, card)
    K = (A, M, D)
    eng4 = phase_four_families(K, clip, unet, launches, card)
    phase_batched(K, eng4, clip.vit.num_layers, launches, card)
    print(f"[done] every phase passed in {time.time() - start:.1f} s from the build on")

    sources = {"fused_attention": ("attention.cu", "image_segmentation_tpu/ops/pallas/attention.py:99"),
               "fused_mlp": ("mlp.cu", "image_segmentation_tpu/ops/pallas/mlp.py:118"),
               "fused_double_conv": ("double_conv.cu",
                                     "image_segmentation_tpu/ops/pallas/double_conv.py:185")}
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"image_segmentation_tpu_torch/csrc/{src}", "replaces": tpu,
         "launches": launches[name], **timing[name]}
        for name, (src, tpu) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
