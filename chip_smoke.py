"""Smoke run of the PyTorch port's serving and training paths on one
CUDA card.

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
  8. training (unet_noaug): `run.main` fits a full-width UNet (base 64,
     256 px, micro 8 x accum 8) for 3 epochs on 512 synthetic images,
     validating on 128 with the device protocol (K1 nine times per eval
     batch), then resumes for a 4th; the train loss must be finite and
     fall, the checkpoints exist, the launches match the eval batches.
     One step at narrow width in bf16 on the card against f32 on the CPU
     (loss, gradient cosines, running statistics); the trained state's
     eval through K1 against the module path; the train step's
     images/s, device busy share and peak memory;
  9. the last line is {"ok": true, "device": {...}}.

The launch counts of phases 4-8 are each set to 0 just before the path
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


def _eval_batches(n_val: int, seed: int, batch: int = 8) -> int:
    """The eval batches of one device-protocol epoch over run.py's
    synthetic val set: its canvas-size buckets, each cut into batches."""
    from image_segmentation_tpu_torch.run import _synthetic_items
    from image_segmentation_tpu_torch.train.fast_eval import plan_size_buckets

    labels = [lab for _, lab in _synthetic_items(n_val, seed)]
    plan = plan_size_buckets(labels) if n_val >= 16 else [range(n_val)]
    return sum(-(-len(b) // batch) for b in plan)


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


# A conv bias that feeds a train-mode BatchNorm has gradient 0 in exact
# arithmetic (BN subtracts the batch mean): its computed gradient is
# rounding noise in any precision, and a cosine between two noises means
# nothing, so those parameters are left out of the gradient checks.
BN_FED_BIAS = ("conv1.conv.bias", "conv2.conv.bias")
STEP_RUNS = (("cpu", torch.float32), ("cpu", torch.bfloat16), ("cuda", torch.float32),
             ("cuda", torch.bfloat16))


def cross_check_step(base: int, side: int, micro: int, accum: int, seed: int = 0) -> dict:
    """One train step of the unet_noaug recipe, from the same weights and
    batch, on the CPU and on the card, each in f32 and in bf16 compute (f32
    parameters, BN statistics and loss). Against the CPU's f32 step, for
    each other run: the loss, every gradient's cosine, the whole gradient's
    relative L2 error, and the largest running-statistic difference scaled
    by max(1, |CPU value|)."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import train_step

    cfg = C.UNET_NOAUG
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (micro * accum, side, side, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (micro * accum, side, side))).long()
    runs = {}
    for device, dtype in STEP_RUNS:
        model = C.build_model(cfg, device, torch.Generator().manual_seed(seed), base=base)
        model.dtype = dtype
        st = TrainState(model, *C.build_optimizer(cfg, model))
        loss = float(train_step(st, C.build_loss(cfg), x.to(device), y.to(device), accum))
        grads = {n: p.grad.double().cpu() for n, p in model.named_parameters()
                 if not n.endswith(BN_FED_BIAS)}
        stats = {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}
        runs[device, dtype] = (loss, grads, stats)
    loss0, g0, s0 = runs["cpu", torch.float32]
    flat0 = torch.cat([g.flatten() for g in g0.values()])
    out = {}
    for key, (loss, g, s) in runs.items():
        if key == ("cpu", torch.float32):
            continue
        cos = {n: float(g[n].flatten() @ g0[n].flatten() / (g[n].norm() * g0[n].norm()))
               for n in g0}
        flat = torch.cat([g[n].flatten() for n in g0])
        worst = min(cos, key=cos.get)
        out[f"{key[0]} {str(key[1])[6:]}"] = {
            "loss_rel": abs(loss - loss0) / abs(loss0), "min_cos": cos[worst],
            "min_cos_param": worst,
            "grad_rel": float((flat - flat0).norm() / flat0.norm()),
            "stat_err": max(float((s[k] - v).abs().max() / max(1.0, float(v.abs().max())))
                            for k, v in s0.items())}
    return out


# Tolerances of the cross-check, against the CPU's f32 step:
# - f32 on the card (cuDNN, TF32 off): every gradient's cosine >= 0.99, the
#   loss within 1e-4 relative, the statistics within 1e-4: f32 sums in
#   another order.
# - bf16 on the card: the bf16 forward rounds inputs, weights and each
#   activation at 2^-9 relative, about 1% of the logits after 19 layers;
#   the loss averages smooth functions of them: 2% relative. A running
#   statistic is 0.9 of the old one plus 0.1 of a batch statistic of bf16
#   conv outputs (a few 2^-9 off): 0.1 · 2^-5 of its scale per update, two
#   updates. Per-gradient cosines do not hold 0.99 in bf16 on any device:
#   the gradients of a randomly initialised train-mode-BN UNet are sums
#   that cancel (each BN backward subtracts the mean of its incoming
#   gradient), so 2^-9 roundings of the summands leave BN affine and deep
#   conv gradients 0.74-0.86 cosine to f32 even on the CPU. The bf16
#   gradient, taken whole, must be as close to f32 as the CPU's bf16
#   step's is: its relative L2 error at most 1.5 times that one.
F32_MIN_COS, F32_LOSS_RTOL, F32_STAT_TOL = 0.99, 1e-4, 1e-4
BF16_LOSS_RTOL, BF16_STAT_TOL, BF16_GRAD_RATIO = 2e-2, 2 * 0.1 * 2.0**-5, 1.5


def check_cross_step(xc: dict) -> None:
    """Raise unless `cross_check_step`'s result holds the tolerances above."""
    f32, bf16, cpu_bf16 = xc["cuda float32"], xc["cuda bfloat16"], xc["cpu bfloat16"]
    if not (f32["min_cos"] >= F32_MIN_COS and f32["loss_rel"] <= F32_LOSS_RTOL
            and f32["stat_err"] <= F32_STAT_TOL):
        raise AssertionError(f"the card's f32 step disagrees with the CPU's: {f32}")
    if not (bf16["loss_rel"] <= BF16_LOSS_RTOL and bf16["stat_err"] <= BF16_STAT_TOL
            and bf16["grad_rel"] <= BF16_GRAD_RATIO * cpu_bf16["grad_rel"]):
        raise AssertionError(f"the card's bf16 step disagrees with the CPU's f32 step beyond "
                             f"bf16's own reach: {bf16}, CPU bf16 {cpu_bf16}")


# Device kernels of a train step by kind, matched on their names in order.
STEP_KERNEL_KINDS = (("batch norm", ("batch_norm",)), ("reductions", ("reduce_kernel",)),
                     ("conv (cuDNN)", ("xmma", "gemm", "conv", "wgrad", "dgrad", "cudnn",
                                       "cutlass", "sm90")),
                     ("elementwise", ("elementwise", "vectorized")), ("copies", ("Memcpy",
                                                                             "Memset")))


def phase_training(K, launches: dict, card: str) -> None:
    """unet_noaug training on the card: the full-width fit through run.py
    and a resume, a bf16-vs-f32 step at narrow width, the trainer's eval
    through K1 against the module path, and the train step's throughput."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch import run as R
    from image_segmentation_tpu_torch.metrics import MetricsHistory
    from image_segmentation_tpu_torch.ops.kernels import double_conv as D
    from image_segmentation_tpu_torch.train.loop import evaluate
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import train_step

    cfg = C.UNET_NOAUG
    n_train, n_val = 512, 128  # run.py: --synthetic N gives N train and N // 4 val
    per_epoch = 9 * _eval_batches(n_val, cfg.seed + 1, cfg.batch_size)
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--config", "unet_noaug", "--synthetic", str(n_train), "--save-dir", tmp,
                "--device", "cuda"]
        # 1. the full-width fit (micro 8 × accum 8), then a resume
        _zero(K)
        t0 = time.time()
        res = R.main(argv + ["--epochs", "3"])
        fit_s = time.time() - t0
        counts = _counts(K)
        _add(launches, K)
        losses = res.history["train_loss"]
        print(f"[train] fit 3 epochs, {n_train} train / {n_val} val synthetic images at "
              f"{cfg.target_size} px, micro {cfg.batch_size} x accum {cfg.accum_steps}: "
              f"{fit_s:.1f} s; train loss {losses}; val mIoU {res.history['val_iou']}; "
              f"launches (attention, mlp, double_conv) {counts}, want (0, 0, {3 * per_epoch}) "
              f"= 9 per eval batch x {per_epoch // 9} eval batches x 3 epochs ({card})")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train losses {losses}: not finite or not falling")
        if counts != (0, 0, 3 * per_epoch):
            raise AssertionError(f"fit launches {counts}, want (0, 0, {3 * per_epoch})")
        for d in ("unet_noaug", "unet_noaug_last", "MO_unet_noaug"):
            if not os.path.isdir(os.path.join(tmp, d)):
                raise AssertionError(f"fit wrote no {d}")
        _zero(K)
        t0 = time.time()
        res = R.main(argv + ["--epochs", "4", "--resume"])
        counts = _counts(K)
        _add(launches, K)
        hist = res.history["train_loss"]
        print(f"[train] resume to 4 epochs: {time.time() - t0:.1f} s; history {hist}; "
              f"launches {counts} ({card})")
        if len(hist) != 4 or hist[:3] != losses or counts != (0, 0, per_epoch):
            raise AssertionError(f"resumed history {hist} from {losses}, launches {counts}")
        state = res.state

    # 2. one step at narrow width on the card against the same step in f32
    # on the CPU, in f32 and in bf16 (and the CPU's own bf16 step beside)
    xc = cross_check_step(base=16, side=64, micro=4, accum=2)
    for run, r in xc.items():
        print(f"[train] one step, UNet base 16, 64 px, micro 4 x accum 2, {run} against cpu "
              f"float32: loss rel {r['loss_rel']:.2e}, lowest gradient cosine "
              f"{r['min_cos']:.6f} ({r['min_cos_param']}), whole-gradient rel L2 "
              f"{r['grad_rel']:.3e}, running statistics max scaled diff {r['stat_err']:.3e}")
    print(f"[train] tolerances: f32 cosine >= {F32_MIN_COS}, loss {F32_LOSS_RTOL}, stats "
          f"{F32_STAT_TOL}; bf16 loss {BF16_LOSS_RTOL}, stats {BF16_STAT_TOL:.3e}, whole "
          f"gradient <= {BF16_GRAD_RATIO} x the CPU's bf16 error (BN-fed conv biases left "
          f"out: exact gradient 0)")
    check_cross_step(xc)

    # 3. the trained state's eval through K1 against the module path
    val = R.synthetic_materialized(n_val, cfg.target_size, cfg.seed + 1, keep_orig_labels=True)
    out = {}
    for kernels in (True, False):
        state.model.use_kernels = kernels
        agg = MetricsHistory(cfg.num_classes, ignore_index=cfg.eval_ignore_index)
        before = D.LAUNCHES
        out[kernels] = (evaluate(state, val, loss_cfg=C.build_val_loss(cfg), agg=agg,
                                 verbose=False), agg.confusion.copy(), D.LAUNCHES - before)
    state.model.use_kernels = True
    (k_res, k_conf, k_n), (m_res, m_conf, m_n) = out[True], out[False]
    moved = np.abs(k_conf - m_conf).sum() / 2 / k_conf.sum()
    print(f"[train] eval of the trained state, device protocol, {n_val} images: mIoU K1 "
          f"{k_res['iou']:.6f} vs module path {m_res['iou']:.6f}; confusion cells moved "
          f"{moved:.6f} of {int(k_conf.sum())} pixels; K1 launches {k_n} and {m_n}")
    if abs(k_res["iou"] - m_res["iou"]) > 0.01 or moved > 0.01 or k_n != per_epoch or m_n:
        raise AssertionError(f"K1 eval vs module eval: {k_res['iou']} vs {m_res['iou']}, "
                             f"moved {moved}, launches {k_n}/{m_n}")

    # 4. train-step throughput at full width, step batch 64, as bench.py's
    # bench_step: a fresh seeded model, one random batch, CUDA events
    model = C.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    st = TrainState(model, *C.build_optimizer(cfg, model))
    rng = np.random.default_rng(0)
    batch = cfg.batch_size * cfg.accum_steps
    x = torch.from_numpy(rng.uniform(0, 1, (batch, 256, 256, 3)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 4, (batch, 256, 256))).cuda()
    loss_fn = C.build_loss(cfg)
    step = lambda: train_step(st, loss_fn, x, y, cfg.accum_steps)  # noqa: E731
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = _cuda_ms(step, iters=12, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(2):
            loss = step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    groups = {}
    for e in rows:
        kind = next((k for k, words in STEP_KERNEL_KINDS if any(w in e.key for w in words)),
                    "other")
        groups[kind] = groups.get(kind, 0.0) + e.self_device_time_total / 2e3
    print(f"[train] train step, UNet base 64, 256 px, batch {batch} (micro {cfg.batch_size} x "
          f"accum {cfg.accum_steps}), bf16: median {step_ms:.3f} ms over 12 steps (CUDA "
          f"events), {batch / step_ms * 1e3:.1f} images/s; peak device memory {peak} bytes; "
          f"loss {float(loss):.4f} ({card})")
    print(f"[train] 2 steps under torch.profiler: device kernels and copies {device_ms:.1f} ms "
          f"in {wall_ms:.1f} ms of wall, busy {100 * device_ms / wall_ms:.1f}% (the profiler "
          f"slows the host); device ms per step against the unprofiled step: "
          f"{device_ms / 2:.1f} of {step_ms:.1f} ms, {50 * device_ms / step_ms:.1f}%")
    print(f"[train] device ms per step by kind: "
          f"{ {k: round(v, 3) for k, v in sorted(groups.items(), key=lambda kv: -kv[1])} }")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[train]   {e.key[:72]:72s} {e.self_device_time_total / 1e3:9.3f} ms x{e.count}")
    if not np.isfinite(float(loss)):
        raise AssertionError("the full-width train step's loss is not finite")


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
    del eng, eng4, clip, unet
    phase_training(K, launches, card)
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
