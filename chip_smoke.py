"""Smoke run of the PyTorch port's serving paths on one CUDA card.

Phases (each prints its lines; any failure ends the run non-zero):
  1. device: requires CUDA, prints the card's name and power limit and
     the TF32 settings;
  2. build: compiles the hand-written kernels from csrc/ with nvcc, one
     process per source, all started together;
  3. kernels: K3 (attention), K4 (MLP) and K1 (double conv) against
     their plain PyTorch versions in bf16 at the serving shapes, with
     median times (K1 also beside the same double conv through cuDNN);
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
  6. the last line is {"ok": true, "device": {...}}.

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

    errs = []
    for shape, v_offset in (((1, 197, 12, 64), 0.0), ((8, 197, 12, 64), 0.0),
                            ((1, 130, 2, 64), 10.0)):
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
    for m in (197, 8 * 197, 333):
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


# The nine double convs of one UNet-64 request at 256 px, in order (stem,
# down 2-5, up 1-4), then a ragged shape with bias1 = +1.
UNET64_LEVELS = ((256, 3, 64), (128, 64, 128), (64, 128, 256), (32, 256, 512),
                 (16, 512, 1024), (32, 1024, 512), (64, 512, 256), (128, 256, 128),
                 (256, 128, 64))


def phase_double_conv(card: str) -> dict:
    from torch import nn

    from image_segmentation_tpu_torch.models.layers import ConvBNRelu
    from image_segmentation_tpu_torch.ops.kernels import double_conv as D

    g = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    errs, total = [], {"ms": 0.0, "plain_ms": 0.0, "cudnn_ms": 0.0}
    cases = [((1, h, h, cin), c, 0.0) for h, cin, c in UNET64_LEVELS]
    cases.append(((1, 37, 45, 24), 72, 1.0))
    for xshape, c, b1_offset in cases:
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
        if b1_offset == 0.0:
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
          f"peak device memory {peak} bytes")

    # The same requests through the plain versions (bf16 scores both ways).
    agree = total = 0
    max_diff = 0.0
    for img in images:
        staged, _ = stage_request(img, CLIPUNET.target_size, eng.fast_transfer)
        s_k = eng.models["clip"].forward(staged[None])[0]
        s_p = eng.models["clip_plain"].forward(staged[None])[0]
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
    staged, _ = stage_request(images[0], CLIPUNET.target_size, eng.fast_transfer)
    x = torch.from_numpy(staged[None]).cuda().float() / 255.0
    with torch.inference_mode():
        fwd_ms = _cuda_ms(lambda: model(x), iters=10)
        plain_fwd_ms = _cuda_ms(lambda: plain(x), iters=10)
    print(f"[serve] segment() 375x500 latency after warm-up: median "
          f"{statistics.median(lat):.3f} ms, min {min(lat):.3f} ms (10 requests, host clock); "
          f"model forward {fwd_ms:.3f} ms with kernels, {plain_fwd_ms:.3f} ms plain "
          f"(CUDA events); {card}")
    return launches, eng


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
        staged, _ = stage_request(img, size, eng.fast_transfer)
        s_k = eng.models["unet"].forward(staged[None])[0]
        s_p = eng.models["unet_plain"].forward(staged[None])[0]
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
    staged, _ = stage_request(images[0], size, eng.fast_transfer)
    x = torch.from_numpy(staged[None]).cuda().float() / 255.0
    with torch.inference_mode():
        fwd_ms = _cuda_ms(lambda: model(x), iters=10)
        plain_fwd_ms = _cuda_ms(lambda: plain(x), iters=10)
    print(f"[unet] segment() 375x500 latency after warm-up: median "
          f"{statistics.median(lat):.3f} ms, min {min(lat):.3f} ms (10 requests, host clock); "
          f"model forward {fwd_ms:.3f} ms with K1, {plain_fwd_ms:.3f} ms module path "
          f"(CUDA events); {card}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from image_segmentation_tpu_torch.ops.kernels import _build
    from image_segmentation_tpu_torch.ops.kernels import attention as A
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

    t0 = time.time()
    _build.build()
    _build.load()
    print(f"[build] nvcc built {_build.LIB_PATH} from {_build.SOURCES} "
          f"in {time.time() - t0:.2f} s")

    timing = phase_kernels(A, M, card)
    launches, eng = phase_serving(A, M, card)
    launches["fused_double_conv"] = phase_unet(eng, card)

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
