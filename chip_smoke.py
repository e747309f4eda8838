"""Smoke run of the PyTorch port's serving and training paths on one
CUDA card.

Phases (each prints its lines; any failure ends the run non-zero):
  1. device: requires CUDA, prints the card's name and power limit and
     the TF32 settings;
  2. build: compiles the hand-written kernels from csrc/ with nvcc, one
     process per source, all started together;
  3. kernels: K3 (attention), K4 (MLP) and K1 (double conv) against
     their plain PyTorch versions in bf16 at every shape the serving
     paths give them: K3 and K4 at batch 1, 2, 4 and 8 (and ragged
     shapes); K1 at the nine levels of the unet family (256 px) and of the
     prompt model's selection UNet (224 px, a Cin = 4 stem), each at
     N = 1, 2, 4 and 8. Each shape prints the kernel's device time
     (`_device_ms`: torch.profiler's CUDA rows over 20 calls) and its time
     from Python (CUDA events around one call: the host's enqueue for a
     short kernel), the plain version's, the bound (bytes or operations at
     the H100's published peaks) and a yardstick: K3 beside one
     F.scaled_dot_product_attention call, K4 beside the LayerNorm ->
     linear -> quick-GELU -> linear chain (no single call computes it).
     K1 is checked at all those shapes and its concat entry (the up
     blocks' [skip, up] read in the load stage) at the four up levels and
     a ragged one, each bit for bit over two calls; then both UNets' nine
     levels at N = 1 and 8 print K1's device time beside the bound,
     cuDNN's conv kernels alone (F.conv2d, bf16, channels_last) and the
     whole library chain conv -> * scale + bias -> ReLU, twice. It also
     prints how far the kernels' SFU exp and division put K3's P and K4's
     G from IEEE exp and division (`fastmath_gap`). Then Segment
     Anything ViT-B's kernels (`phase_sam_kernels`): K5 against its plain
     version at a windowed block's 200 windows of 14 x 14 and a global
     block's 8 maps of 64 x 64, and K4 with the exact GELU at 32,768
     tokens, eps 1e-6 (v3, the many-token design, beside v2), each timed
     beside its bound; K4's crossover sweep, v2 against v3 at 1,576 to
     32,768 tokens with both GELUs; one SamViTB forward at micro-batch 8
     (1024 px) launches each 12 times, K4 all 12 on v3;
  4. serving, clip family: a full-width ClipUNet (ViT-B/16 widths, seeded
     random weights, bf16, kernels on) registered in the port's
     InferenceEngine serves host images of several sizes; the launch
     counters must show 12 launches of K3 and K4 per request; the same
     requests through the plain versions must agree; the forward's device
     time at batch 1 and 8;
  5. serving, unet family: a full-width UNet (base 64, 256 px, seeded
     random weights and BN statistics, bf16, K1 on), registered as
     `unet` beside `clip` in the same engine, serves the same images
     with 9 K1 launches per request; the same requests through the
     module path (cuDNN, bf16) must agree; the forward's device time
     through K1 and through the module path at batch 1 and 8, beside its
     bound;
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
  9. training (unet_aug): `run.main` fits the full-width UNet for 2
     epochs on 128 synthetic images with online augmentation (K1 in
     every eval epoch; about half the rows of each step batch changed),
     then 1 epoch of `--offline-aug` on 16 items; the step with and
     without augmentation in turns, the augmentation call's own ms, and
     its device ms on a 64-row batch by augmenter (torch.profiler);
 10. training (the two-stage autoencoder, base 64, 256 px): `recon_ae`
     for 2 epochs, then `autoencoder --pretrained-encoder` for 2; the
     encoder equals the recon checkpoint's after the transfer and its
     parameters are unchanged after the frozen stage 2; each stage's
     step ms;
 11. CLIP training at full width (ViT-B/16, decoder 1024..64, 224 px,
     seeded random weights, bf16, K3/K4 on) through `run.main`: a random
     ViT converted to a CLIP .npz by the port's converter; `clipunet` for
     2 epochs on 128 synthetic images with `--clip-weights` (the run's ViT
     must equal the file's), the same run with `--cache-features` (step
     1's loss must be equal in both), `clipunet_noskips` for 1 epoch. K3
     and K4 launch 12 times per train micro-batch forward and per eval
     batch in line, per encode batch and per eval batch cached, K1 never.
     Then the in-line and the cached step at batch 64 (8 x 8): ms,
     images/s, device busy share, peak memory; and the encode's ms an
     image;
 12. prompt training at full width through `run.main`: `prompt
     --clipunet-checkpoint` on phase 11's MO_ for 1 epoch; the grafted
     clip branch equals the checkpoint, its ViT is unchanged by training,
     K1 launches 9 times per eval batch and K3/K4 12 times per eval batch
     and per train micro-batch; the step's ms;
 13. serving what phases 8 and 10-12 trained (MO_unet_noaug, MO_autoencoder,
     MO_clipunet, MO_prompt, kept in one models directory), at full width:
     `build_engine_from_checkpoints` on cuda, each family at phase 6's
     image sizes with phase 6's launches a request (unet K1 9; clip K3/K4
     12/12; prompt_model 12/12/9 on a first click, 0/0/9 on a repeat); the
     same state_dicts on the plain versions in bf16 and in f32: the scores
     no farther from the f32 forward than the plain bf16 forward's (1.5x,
     relative L2), argmax agreement with it >= 0.99; the HTTP app in a thread on 127.0.0.1 (GET
     / is the template, GET /static/script.js, one POST /segment a family,
     a box prompt for prompt_model, on a PNG whose rows use every filter,
     and that upload's decode ms); `predict.main` over 16 synthetic PNGs
     of mixed sizes with class-id labels, their rows using every filter,
     each family (images/s; the mIoU is of smoke weights);
     `export_registry` on cuda and
     `register_exported` of each program: scores within 2^-6 of the live
     engine's and the same K1/K3/K4 launches a request as the live path's
     first (each program's bytes and load seconds); then each family's
     single-request latency, p50 and p90 over 20 requests after warm-up,
     live and exported, with the host and device time of one program
     dispatch;
 14. the host data path (`phase_host_data`): both host libraries built
     from native/*.cpp with their build times (the codec only where
     libpng's and libjpeg's headers are there, else a printed finding and
     the fallback decoders); a Pet-shaped file set (256 train and 64 val
     images, sides 200-500 px, JPEG through PIL or else PNG, trimaps
     {1, 2, 3}) materialised natively and item by item (images within
     2e-2, labels and metas equal; images/s of each with the worker and
     CPU counts); `run.py unet_noaug --data-root` at full width for 2
     epochs streamed (ISTPU_TRAIN_DEVICE_CACHE_MB=16,
     ISTPU_EVAL_DEVICE_CACHE_MB=1; K1 nine times per eval batch) and
     resident, cuDNN deterministic: step losses within 1e-3 relative,
     the per-batch eval equal to the resident eval on one state, the two
     runs' confusions equal (pixel agreement >= 0.999 if the card's
     kernels are not deterministic, said so), the streamed run's train
     and eval both through their per-batch paths; the step fed resident
     and streamed (the gather on `stream_rows`' worker, and on the
     step's thread for comparison) in interleaved rounds over one
     unbroken order (ms, host ms, kernel ms, copy ms, idle share), and
     one step batch's host gather and copy;
 15. data parallelism across processes (`phase_data_parallel`), children
     of this script (`--dp-child`), each with a timeout and its exit code
     checked: (a) one full-width UNet-64 step (256 px, micro 8 x accum 8,
     bf16) in 2 ranks sharing the card over gloo against the single-process
     step from the same weights and batch: the loss, the update's cosine
     and the running statistics within the step's own bf16 error (phase
     8's bounds), both ranks' states equal, each step's ms; (b) `run.py
     --multihost unet_noaug` in 2 ranks at full width, 2 epochs: each
     rank's K1 launches 9 per eval batch, histories and confusions equal
     across ranks, rank 1 writes nothing; (c) `clipunet` in line (ViT-B/16,
     224 px) under `--multihost`, 1 rank over NCCL (run beside (b)), then 2
     ranks over gloo: K3/K4 12 launches per micro-batch forward and per
     eval batch on each rank;
 16. model parallelism and mesh serving (`phase_model_parallel`), in 2
     ranks sharing the card over gloo, children of this script
     (`--dp-child`), each part against one process on the same weights
     and inputs: (a) TP over the ViT (dp1 x tp2): the full-width ClipUNet
     forward (224 px, B 8) with K3 on 6 local heads and K4's TP entry
     (`fused_mlp_partial`) at F 1536, 12 launches each a rank, the logits
     no farther from the f32 forward than 1.5x one process's bf16
     forward's; one `clipunet` in-line step with the frozen ViT under TP,
     its loss within phase 8's bf16 bound; (b) GPipe over ViT-B/16's 12
     blocks in 2 stages of 6, M = 4 at B 8, forward only (the kernels
     refuse autograd): the final and all 12 per-layer states by the same
     bound, K3/K4 24 launches a stage (bubble ticks skipped); (c) SP of the
     UNet-64 at 256 px in 2 shards of 128 rows: the eval forward through
     K1 on haloed slabs, 9 launches a rank, by the same bound; one
     full-width step (micro 8 x accum 8, bf16, module path) against phase
     15's one-process step with phase 15(a)'s bounds; (d) mesh serving:
     the four full-width families on InferenceEngine(devices=[cuda:0,
     cuda:0]) with batches of 4, each in 2 chunks of 2 whose scores equal
     the one-device engine's chunks and whose launches are twice a
     chunk's; (e) each part's ms against one process (gloo through the
     host: the code path, not scaling);
 17. the reference study (`phase_study`) at full width through the port's
     study modules, as a user runs them: (a) `scripts/fullscale.py
     --images 64 --epochs 1 --patience 0 --batch 8 --target-size 256`: a
     pseudo-Pet source, its preparation (0.15/0.15), `unet_aug` (offline
     augmentation) and `unet_noaug` at UNet-64, the 8 x 10 device-path sweep
     of both on Test, K1 nine times per Val, Test and sweep batch; (b)
     `scripts/reproduce_reference.py --rows clip_aug,clip_noaug,autoencoder,
     prompt --epochs 1 --batch-size 8` on the same tree with a converted
     random ViT-B/16 (`--clip-weights`); (c) the unet_noaug and prompt best
     checkpoints re-scored on Test with the kernels off (acc, dice and iou
     each within 2e-3; no launch), and the sweep's u8 device path against
     its host path on 2 families x 2 severities (within 5e-3); (d)
     `studies/ablations.py --images 32 --epochs 1 --clip-pre-epochs 1
     --clip-epochs 1`, all five experiments (K1 in the UNet evals, K3/K4 in
     the frozen ViT's forwards). First, K1, K3 and K4 are held against their
     plain versions at the shapes this phase adds to phase 3's
     (`check_study_kernels`: K1 at the sweep's batch of 9, the ablations'
     base-32 UNets at 256 and 512 px and their Cin = 4 selection UNet; K3
     and K4 at the ablations' narrow ViT). Each step's wall seconds, each
     row's Test metrics and the sweep's images/s are printed; every metric
     is of one epoch and random weights, not a quality result;
 18. the speed probes and parity rehearsals (`phase_probes`) at full width
     through their `main`s, as a user runs them: `probes.confusion_probe`
     (bincount, one-hot product and scatter-add counts equal), `eval_bench
     --images 128` (device and host protocols; metrics_match_host_oracle;
     K1 nine times a batch; the device metrics within 2e-3 of the module
     path's), `serve_profile --steps 20` (K1 in the forward; its mask on
     >= 0.99 of the module path's pixels, and as close to the float32
     forward's as the module path's bf16 mask), `profile_train_step
     --steps 5`, `step_variants` (all five, 3 steps), `backward_anatomy
     --per-conv` (the buckets within 2% of the trace's device time),
     `reference_anchor --mode torch-samechip` over 2 windows of 32,
     `studies.bn_regime --seeds 1 --epochs 1` and `studies.
     convergence_rehearsal --epochs 2` (its first-step check); the K1
     launches of each counted against its eval batches and forwards; then
     K1 and its concat entry against their plain versions at every shape
     the phase gave them that phase 3 does not check;
 19. the last line is {"ok": true, "device": {...}}.

Phase 3 also prints each kernel's host dispatch at one request's shape
through its wrapper's direct path and through its torch op (the path of
an exported program), and checks and times K4's tensor-parallel entry
(`fused_mlp_partial`) at 197 and 1576 tokens with F 1536 as it times K4.
The launch counts of phases 4-18 are each set to 0 just before the path
is driven and read just after (in each child process for phases 15 and
16); the kernels line sums them (phase 17's (c) and phase 18's comparisons
with the module path and the plain version are not counted).

Run from the repository root: python3 chip_smoke.py (no arguments).
"""
from __future__ import annotations

import contextlib
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
    """Median milliseconds of fn() from Python: a pair of CUDA events around
    one call. For a kernel of tens of microseconds this is the host's
    enqueue (argument checks, allocation, the ctypes call), not the
    device's time; `_device_ms` gives that."""
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


def _profile_session(fn, iters: int) -> dict:
    """kernel → (count, device µs) of `iters` fn() calls under torch.profiler:
    the key_averages() rows whose device_type is CUDA."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type.name == "CUDA"}


def _device_profile(fn, iters: int = 20, warmup: int = 3) -> dict:
    """Device milliseconds of one fn() call by kernel: `iters` calls under
    torch.profiler, the key_averages() rows whose device_type is CUDA
    (every kernel, copy and memset the calls ran) divided by `iters`.
    Warm L2: the same inputs every call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # A profiler session now and then loses device records (one of its
    # activity buffers comes back empty): no rows at all, or a kernel seen
    # fewer times than the calls launched it, which reads far below the
    # bound (in one session exactly half of them). Every session runs the
    # same calls, so whole sessions agree on every kernel's count, while a
    # lost record (or a one-off launch) makes one session differ; a count
    # need not be a multiple of `iters` (the UNet forward through K1 runs
    # one bf16 copy kernel 49 times in 5 calls in every session). Sessions
    # run until two agree on every count, up to 8; of those the larger
    # total wins, as a lost record only ever lowers the time.
    sessions = []
    for _ in range(8):
        rows = _profile_session(fn, iters)
        counts = {k: c for k, (c, _) in rows.items()}
        same = [r for r in sessions if {k: c for k, (c, _) in r.items()} == counts]
        sessions.append(rows)
        if rows and same:
            best = max(same + [rows], key=lambda r: sum(t for _, t in r.values()))
            return {k: t / 1e3 / iters for k, (_, t) in best.items()}
    raise RuntimeError(
        f"torch.profiler lost device records: no two of 8 sessions of {iters} calls agreed on "
        f"every kernel's count (device ms, kernels seen): "
        f"{[(sum(t for _, t in r.values()) / 1e3, len(r)) for r in sessions]}")


def _device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds of one fn() call, all its kernels summed."""
    return sum(_device_profile(fn, iters, warmup).values())


def _short(kernel: str) -> str:
    """A kernel's name without its namespace and arguments."""
    import re

    m = re.search(r"::(\w+(?:<[^>]*>)?)\(", kernel)
    return m.group(1) if m else kernel[:40]


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): the
# bounds below are the larger of bytes over the memory rate and bf16
# operations over the tensor-core rate, each input read once and each
# output written once.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def _bound(nbytes: float, flops: float):
    """(bound_ms, bound_by) of a call that moves nbytes and does flops."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def attention_bound(b: int, s: int, h: int, d: int):
    """q, k, v read and out written in bf16; QKᵀ and P·V."""
    return _bound(4 * b * s * h * d * 2, 4 * b * h * s * s * d)


def mlp_bound(m: int, hdim: int, fdim: int):
    """x read and out written in bf16, both weights in bf16, LN params and
    biases in f32; fc1 and fc2."""
    return _bound(2 * m * hdim * 2 + 2 * fdim * hdim * 2 + (3 * hdim + fdim) * 4,
                  4 * m * hdim * fdim)


def double_conv_bound(n: int, h: int, w: int, cin: int, c: int):
    """x read and out written in bf16, both HWIO weights in bf16, four f32
    vectors; two 3x3 convs."""
    return _bound(n * h * w * (cin + c) * 2 + 9 * (cin * c + c * c) * 2 + 4 * c * 4,
                  2 * n * h * w * 9 * (cin * c + c * c))


def unet_forward_bound(n: int, side: int, cin: int, classes: int = 4) -> dict:
    """The bound of a UNet-64 inference forward as the port runs it, summed
    over its ops, each op's inputs read once and outputs written once in
    bf16 (f32 logits): K1's nine double convs, and K2's pre-stages (four
    2x2 max pools, four 2x2 stride-2 transpose convs) and the 1x1 head.
    Returns ms for "k1", "k2" (the eight blocks: their K1 and pre-stages)
    and "forward" (everything)."""
    levels = unet64_levels(side, cin)
    k1 = [double_conv_bound(n, h, h, ci, c)[0] for h, ci, c in levels]
    pools = [_bound(5 * n * h * h * ci * 2, 0)[0] for h, ci, _ in levels[1:5]]  # 2h² in, h² out
    ups = []
    for h, ci, c in levels[5:]:  # the up conv takes 2c channels at h/2 to c at h
        hh = h // 2
        ups.append(_bound(n * hh * hh * 2 * c * 2 + 2 * c * c * 4 * 2 + n * h * h * c * 2,
                          2 * n * hh * hh * 2 * c * c * 4)[0])
    head = _bound(n * side * side * (64 * 2 + classes * 4), 2 * n * side * side * 64 * classes)[0]
    return {"k1": sum(k1), "k2": sum(k1[1:]) + sum(pools) + sum(ups),
            "forward": sum(k1) + sum(pools) + sum(ups) + head}


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


# K3 at every batch the serving paths give it (BatchingEngine buckets 1, 2,
# 4, 8 of ViT-B/16), then a TP rank's 6 local heads at B 8 (phase 16 (a):
# q/k/v are views of a (8, 197, 384) projection, token stride 384), then
# ragged sequences: S = 130 with V offset by +10 (mass leaking onto padded
# keys would show), and the longest admitted.
ATTENTION_CASES = [((b, 197, 12, 64), 0.0) for b in (1, 2, 4, 8)] + [
    ((8, 197, 6, 64), 0.0), ((1, 130, 2, 64), 10.0), ((2, 256, 12, 64), 0.0)]
# K4 at the same batches (197 tokens a request), then a ragged token count.
MLP_TOKENS = [b * 197 for b in (1, 2, 4, 8)] + [333]


def phase_attention(A, card: str) -> dict:
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    errs, rows = [], {}
    for shape, v_offset in ATTENTION_CASES:
        q, k = rnd(*shape).bfloat16(), rnd(*shape).bfloat16()
        v = (rnd(*shape) + v_offset).bfloat16()
        got = A.fused_attention(q, k, v)
        torch.cuda.synchronize()
        errs.append(_compare(f"attention {shape} v+{v_offset}", got,
                             A.attention_reference(q, k, v)))
        kernel = lambda: A.fused_attention(q, k, v)  # noqa: E731
        plain = lambda: A.attention_reference(q, k, v)  # noqa: E731
        # the yardstick: one PyTorch call on the same (B, H, S, D) views
        views = [t.transpose(1, 2) for t in (q, k, v)]
        sdpa = lambda: F.scaled_dot_product_attention(*views)  # noqa: E731
        bound_ms, bound_by = attention_bound(*shape)
        row = {"device_ms": _device_ms(kernel), "ms": _cuda_ms(kernel),
               "plain_ms": _cuda_ms(plain), "plain_device_ms": _device_ms(plain),
               "library_ms": _device_ms(sdpa), "bound_ms": bound_ms, "bound_by": bound_by}
        rows[shape] = row
        print(f"[kernels] attention {shape}: device {row['device_ms']:.4f} ms, from Python "
              f"{row['ms']:.4f} ms; plain device {row['plain_device_ms']:.4f} ms, from Python "
              f"{row['plain_ms']:.4f} ms; SDPA device {row['library_ms']:.4f} ms; bound "
              f"{bound_ms:.5f} ms ({bound_by}); device / bound {row['device_ms'] / bound_ms:.1f}, "
              f"device / SDPA {row['device_ms'] / row['library_ms']:.2f} (20 calls, warm L2; "
              f"{card})")
    out = dict(rows[(1, 197, 12, 64)], at="(1, 197, 12, 64) bf16", max_abs_err=max(errs))
    out["device_ms_b8"] = rows[(8, 197, 12, 64)]["device_ms"]
    return out


def phase_mlp(M, card: str) -> dict:
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    errs, rows = [], {}
    for m in MLP_TOKENS:
        x = (0.5 * rnd(1, m, 768)).bfloat16()
        ln_w, ln_b = 1.0 + 0.1 * rnd(768), 0.1 * rnd(768)
        w1, b1 = (0.03 * rnd(3072, 768)).bfloat16(), 0.1 * rnd(3072)
        w2, b2 = (0.03 * rnd(768, 3072)).bfloat16(), 0.1 * rnd(768)
        args = (x, ln_w, ln_b, w1, b1, w2, b2, 1e-5)
        got = M.fused_mlp(*args)
        torch.cuda.synchronize()
        errs.append(_compare(f"mlp tokens={m} 768->3072->768", got, M.mlp_reference(*args)))
        kernel = lambda: M.fused_mlp(*args)  # noqa: E731
        plain = lambda: M.mlp_reference(*args)  # noqa: E731
        # No single PyTorch call computes K4; the nearest chain, for reference:
        # LayerNorm -> linear -> quick-GELU -> linear -> residual, all bf16.
        lw, lb, bb1, bb2 = (t.bfloat16() for t in (ln_w, ln_b, b1, b2))

        def chain():
            h = F.linear(F.layer_norm(x, (768,), lw, lb, 1e-5), w1, bb1)
            return x + F.linear(h * torch.sigmoid(1.702 * h), w2, bb2)

        bound_ms, bound_by = mlp_bound(m, 768, 3072)
        split = _device_profile(kernel)
        row = {"device_ms": sum(split.values()), "ms": _cuda_ms(kernel),
               "plain_ms": _cuda_ms(plain), "plain_device_ms": _device_ms(plain),
               "chain_ms": _device_ms(chain), "bound_ms": bound_ms, "bound_by": bound_by}
        rows[m] = row
        print(f"[kernels] mlp tokens={m}: device {row['device_ms']:.4f} ms, from Python "
              f"{row['ms']:.4f} ms; plain device {row['plain_device_ms']:.4f} ms, from Python "
              f"{row['plain_ms']:.4f} ms; LN-linear-GELU-linear chain device "
              f"{row['chain_ms']:.4f} ms (not a single call); bound {bound_ms:.5f} ms "
              f"({bound_by}); device / bound {row['device_ms'] / bound_ms:.1f} (20 calls, warm "
              f"L2; {card}); by kernel "
              f"{ {_short(k): round(v, 4) for k, v in split.items()} }")
    out = dict(rows[197], at="197 tokens, 768->3072->768 bf16", library_ms=None,
               max_abs_err=max(errs))
    out["device_ms_1576"] = rows[1576]["device_ms"]
    return out


# K4's tensor-parallel entry at ViT-B/16's F / 2 (a model axis of 2): one
# request's tokens and the largest bucket's.
MLP_PARTIAL_TOKENS = (197, 1576)
MLP_PARTIAL_F = 1536


def mlp_partial_bound(m: int, hdim: int, fdim: int):
    """x read in bf16 and the f32 output written, both weights in bf16, LN
    params and b1 in f32; fc1 and fc2 (no b2, no residual)."""
    return _bound(m * hdim * (2 + 4) + 2 * fdim * hdim * 2 + (2 * hdim + fdim) * 4,
                  4 * m * hdim * fdim)


def phase_mlp_partial(M, card: str) -> dict:
    """K4's TP entry (`fused_mlp_partial`) against its plain version, timed
    as K4 is, beside the LN -> linear -> quick-GELU -> linear chain at the
    same F (no single PyTorch call computes it)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    f = MLP_PARTIAL_F
    errs, rows = [], {}
    for m in MLP_PARTIAL_TOKENS:
        x = (0.5 * rnd(1, m, 768)).bfloat16()
        ln_w, ln_b = 1.0 + 0.1 * rnd(768), 0.1 * rnd(768)
        w1, b1 = (0.03 * rnd(f, 768)).bfloat16(), 0.1 * rnd(f)
        w2 = (0.03 * rnd(768, f)).bfloat16()
        args = (x, ln_w, ln_b, w1, b1, w2, 1e-5)
        got = M.fused_mlp_partial(*args)
        torch.cuda.synchronize()
        errs.append(_compare(f"mlp partial (TP entry) tokens={m} 768->{f}->768 f32 out", got,
                             M.mlp_partial_reference(*args)))
        if not torch.equal(got, M.fused_mlp_partial(*args)):
            raise AssertionError("fused_mlp_partial: two calls differ")
        kernel = lambda: M.fused_mlp_partial(*args)  # noqa: E731
        plain = lambda: M.mlp_partial_reference(*args)  # noqa: E731
        lw, lb, bb1 = (t.bfloat16() for t in (ln_w, ln_b, b1))

        def chain():
            h = F.linear(F.layer_norm(x, (768,), lw, lb, 1e-5), w1, bb1)
            return F.linear(h * torch.sigmoid(1.702 * h), w2)

        bound_ms, bound_by = mlp_partial_bound(m, 768, f)
        split = _device_profile(kernel)
        row = {"device_ms": sum(split.values()), "ms": _cuda_ms(kernel),
               "plain_ms": _cuda_ms(plain), "plain_device_ms": _device_ms(plain),
               "chain_ms": _device_ms(chain), "bound_ms": bound_ms, "bound_by": bound_by}
        rows[m] = row
        print(f"[kernels] mlp partial tokens={m} F={f}: device {row['device_ms']:.4f} ms, "
              f"from Python {row['ms']:.4f} ms; plain device {row['plain_device_ms']:.4f} ms, "
              f"from Python {row['plain_ms']:.4f} ms; LN-linear-GELU-linear chain device "
              f"{row['chain_ms']:.4f} ms (not a single call); bound {bound_ms:.5f} ms "
              f"({bound_by}); device / bound {row['device_ms'] / bound_ms:.1f} (20 calls, warm "
              f"L2; {card}); by kernel "
              f"{ {_short(k): round(v, 4) for k, v in split.items()} }")
    out = dict(rows[197], at=f"197 tokens, 768->{f}->768 bf16, f32 out", library_ms=None,
               max_abs_err=max(errs))
    out["device_ms_1576"] = rows[1576]["device_ms"]
    return out


def fastmath_gap(card: str) -> dict:
    """How far K3's P and K4's G, with exp and the division on the SFU as
    the kernels compute them (__expf, __fdividef), lie from IEEE exp and
    division, on the inputs phase 3 gives K3 at (1, 197, 12, 64) and K4 at
    197 tokens: the largest gap in f32 (absolute, and in f32 ulps of the
    IEEE value) and after the bf16 rounding both get (elements that differ,
    largest gap in bf16 steps). The SFU side runs the kernels' expressions
    through NVRTC (torch.cuda.jiterator), the IEEE side torch's own ops."""
    from torch.cuda import jiterator

    fast_exp = jiterator._create_jit_fn(
        "template <typename T> T fast_exp(T x) { return __expf(x); }")
    fast_div = jiterator._create_jit_fn(
        "template <typename T> T fast_div(T a, T b) { return __fdividef(a, b); }")
    fast_gelu = jiterator._create_jit_fn(
        "template <typename T> T fast_gelu(T h) "
        "{ return h * __fdividef(1.f, 1.f + __expf(-1.702f * h)); }")

    def gap(fast, ieee):
        _, e = torch.frexp(ieee)
        ulps = (fast - ieee).abs() / torch.ldexp(torch.ones_like(ieee), e - 24)
        fb, ib = fast.bfloat16().float(), ieee.bfloat16().float()
        _, eb = torch.frexp(ib)
        steps = (fb - ib).abs() / torch.ldexp(torch.ones_like(ib), eb - 8)
        return {"max_abs": (fast - ieee).abs().max().item(),
                "max_f32_ulps": ulps[ieee != 0].max().item(),
                "bf16_differ": int((fb != ib).sum().item()), "of": ieee.numel(),
                "max_bf16_steps": steps[ib != 0].max().item()}

    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    q, k = rnd(1, 197, 12, 64).bfloat16(), rnd(1, 197, 12, 64).bfloat16()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 0.125
    x = logits - logits.amax(-1, keepdim=True)
    e_fast, e_ieee = fast_exp(x), torch.exp(x)
    p_fast = fast_div(e_fast, e_fast.sum(-1, keepdim=True).expand_as(e_fast))
    out = {"P (1, 197, 12, 64)": gap(p_fast, e_ieee / e_ieee.sum(-1, keepdim=True))}

    g.manual_seed(0)
    xm = (0.5 * rnd(1, 197, 768)).bfloat16()
    ln_w, ln_b = 1.0 + 0.1 * rnd(768), 0.1 * rnd(768)
    w1, b1 = (0.03 * rnd(3072, 768)).bfloat16(), 0.1 * rnd(3072)
    ln = torch.nn.functional.layer_norm(xm.float(), (768,), ln_w, ln_b, 1e-5).bfloat16()
    h = ln.float() @ w1.float().t() + b1
    out["G 197 tokens"] = gap(fast_gelu(h), h * (1.0 / (1.0 + torch.exp(-1.702 * h))))
    for name, row in out.items():
        print(f"[kernels] SFU exp/division against IEEE, {name}: {row} ({card})")
    return out


def _host_us(fn, calls: int = 200) -> float:
    """µs a call on the host's clock: `calls` back-to-back calls, then one
    sync. At one request's shapes each call enqueues more slowly than the
    card runs it, so this is the host's dispatch."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e6


def op_dispatch_us(A, M, D, card: str) -> None:
    """Each kernel at one request's shape through its wrapper's direct path
    (eager serving) and through its torch.library op (the path an exported
    program takes): host µs a call, the same bits, one launch a call."""
    from image_segmentation_tpu_torch.ops.kernels import _build

    g = torch.Generator(device="cuda").manual_seed(5)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    q, k, v = (rnd(1, 197, 12, 64).bfloat16() for _ in range(3))
    x = (0.5 * rnd(1, 197, 768)).bfloat16()
    mlp_args = (x, 1.0 + 0.1 * rnd(768), 0.1 * rnd(768), (0.03 * rnd(3072, 768)).bfloat16(),
                0.1 * rnd(3072), (0.03 * rnd(768, 3072)).bfloat16(), 0.1 * rnd(768), 1e-5)
    dc_args = _k1_args(g, (1, 16, 16, 512), 1024, 0.0)
    cases = (("fused_attention", (q, k, v), A.fused_attention, A.attention_op),
             ("fused_mlp", mlp_args, M.fused_mlp, M.mlp_op),
             ("fused_double_conv", dc_args, D.fused_double_conv, D.double_conv_op))
    for name, args, direct, op in cases:
        before = _build.launch_counts()
        same = torch.equal(direct(*args), op(*args))
        counted = sum(_build.launches_since(before).values())
        d_us, o_us = _host_us(lambda: direct(*args)), _host_us(lambda: op(*args))
        print(f"[kernels] {name} host dispatch at one request's shape: direct {d_us:.1f} us a "
              f"call, torch op {o_us:.1f} us (+{o_us - d_us:.1f}); the op's bits equal the "
              f"direct call's {same}; launches counted for one call each {counted} ({card})")
        if not same or counted != 2:
            raise AssertionError(f"{name}: op and direct call differ ({same}) or "
                                 f"counted {counted} launches for 2 calls")


# Segment Anything ViT-B's kernel calls at micro-batch 8 (models/sam.py):
# K5 over the 200 14 x 14 windows of a windowed block and over the 8
# global 64 x 64 maps, q, k and v sliced out of one qkv projection as the
# encoder hands them over; K4 with the exact GELU at the encoder's 8 x
# 4,096 tokens, eps 1e-6.
SAM_K5_CASES = ((200, 14, 14), (8, 64, 64))
SAM_MLP_TOKENS = 8 * 4096


def relpos_bound(bp: int, h: int, w: int, heads: int = 12, d: int = 64):
    """q, k, v read and out written in bf16, and the two tables; QKᵀ, P·V
    and the relative terms' S·(h + w) dot products."""
    s = h * w
    return _bound(2 * (4 * bp * s * heads * d + (2 * h - 1 + 2 * w - 1) * d),
                  4 * bp * heads * s * s * d + 2 * bp * heads * s * (h + w) * d)


# K4 v3 against v2 at H 768, F 3,072, both GELUs: the sweep behind the
# crossover `ops/kernels/mlp.py` MANY_TOKENS.
MLP_SWEEP_TOKENS = (1576, 3152, 4096, 6304, 8192, 12608, 32768)


@contextlib.contextmanager
def _mlp_design(M, design: str):
    """K4 held to one design, "v2" or "v3", whatever the token count."""
    keep = M.MANY_TOKENS
    M.MANY_TOKENS = 1 if design == "v3" else 10**9
    try:
        yield
    finally:
        M.MANY_TOKENS = keep


def mlp_crossover_sweep(M, g, card: str) -> list:
    """Device ms and ms from Python (`_cuda_ms`, which holds the host's
    enqueue) of v2 and v3 at each MLP_SWEEP_TOKENS count and GELU, and
    which design the plan takes there."""
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for act in ("gelu", "quick_gelu"):
        for m in MLP_SWEEP_TOKENS:
            args = ((0.5 * rnd(1, m, 768)).bfloat16(), 1.0 + 0.1 * rnd(768), 0.1 * rnd(768),
                    (0.03 * rnd(3072, 768)).bfloat16(), 0.1 * rnd(3072),
                    (0.03 * rnd(768, 3072)).bfloat16(), 0.1 * rnd(768), 1e-6)
            fn = lambda: M.fused_mlp(*args, activation=act)  # noqa: E731
            row = {"activation": act, "tokens": m,
                   "plan": ("v3" if isinstance(M.mlp_plan(m, 768, 3072, sms), M.ManyTokenPlan)
                            else "v2")}
            for design in ("v2", "v3"):
                with _mlp_design(M, design):
                    row[design] = (_device_ms(fn), _cuda_ms(fn))
            print(f"[kernels] mlp sweep {act} tokens={m}: device v2 {row['v2'][0]:.4f} v3 "
                  f"{row['v3'][0]:.4f} ms; from Python v2 {row['v2'][1]:.4f} v3 "
                  f"{row['v3'][1]:.4f} ms; the plan takes {row['plan']} ({card})")
            rows.append(row)
    return rows



def phase_sam_kernels(M, card: str) -> tuple:
    """K5 and K4's exact GELU against their plain versions at SAM ViT-B's
    shapes, each timed beside its bound, K4 (which the plan sends to v3 at
    32,768 tokens) beside v2 at the same shape, then K4's crossover sweep
    (`mlp_crossover_sweep`); then one SamViTB forward at micro-batch 8
    (1024 px, seeded random weights, bf16, kernels on) must launch each 12
    times, K4 all 12 on v3. Returns (K5's row, K4's exact-GELU numbers,
    the forward's (K5, K4) launches)."""
    from image_segmentation_tpu_torch.models import sam
    from image_segmentation_tpu_torch.ops.kernels import relpos_attention as R

    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    errs, rows = [], {}
    for bp, h, w in SAM_K5_CASES:
        q, k, v = rnd(bp, h * w, 3, 12, 64).bfloat16().unbind(2)
        args = (q, k, v, (0.1 * rnd(2 * h - 1, 64)).bfloat16(),
                (0.1 * rnd(2 * w - 1, 64)).bfloat16())
        got = R.relpos_attention(*args)
        torch.cuda.synchronize()
        shape = (bp, h * w, 12, 64)
        errs.append(_compare(f"relpos_attention {shape} over {h} x {w}", got,
                             R.relpos_attention_reference(*args)))
        torch.cuda.empty_cache()
        bound_ms, bound_by = relpos_bound(bp, h, w)
        row = {"device_ms": _device_ms(lambda: R.relpos_attention(*args)),
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows[shape] = row
        print(f"[kernels] relpos_attention {shape}: device {row['device_ms']:.4f} ms; bound "
              f"{bound_ms:.5f} ms ({bound_by}); device / bound "
              f"{row['device_ms'] / bound_ms:.2f} (20 calls, warm L2; {card})")
    windows, glob = rows[(200, 196, 12, 64)], rows[(8, 4096, 12, 64)]
    k5 = dict(windows, at="(200, 196, 12, 64) bf16, 14 x 14 windows", max_abs_err=max(errs),
              device_ms_global=glob["device_ms"], bound_ms_global=glob["bound_ms"])

    x = (0.5 * rnd(1, SAM_MLP_TOKENS, 768)).bfloat16()
    args = (x, 1.0 + 0.1 * rnd(768), 0.1 * rnd(768), (0.03 * rnd(3072, 768)).bfloat16(),
            0.1 * rnd(3072), (0.03 * rnd(768, 3072)).bfloat16(), 0.1 * rnd(768), 1e-6)
    before = M.MANY_TOKEN_LAUNCHES
    got = M.fused_mlp(*args, activation="gelu")
    torch.cuda.synchronize()
    if M.MANY_TOKEN_LAUNCHES != before + 1:
        raise AssertionError(f"K4 at {SAM_MLP_TOKENS} tokens did not run v3")
    err = _compare(f"mlp exact GELU tokens={SAM_MLP_TOKENS} 768->3072->768 eps 1e-6 (v3)", got,
                   M.mlp_reference(*args, activation="gelu"))
    bound_ms, bound_by = mlp_bound(SAM_MLP_TOKENS, 768, 3072)
    fn = lambda: M.fused_mlp(*args, activation="gelu")  # noqa: E731
    rows = _device_profile(fn)
    erf_ms = sum(rows.values())
    with _mlp_design(M, "v2"):
        v2_ms = _device_ms(fn)
    print(f"[kernels] mlp exact GELU tokens={SAM_MLP_TOKENS}: v3 device {erf_ms:.4f} ms ("
          + ", ".join(f"{_short(k)} {t:.4f}" for k, t in rows.items())
          + f"); v2 {v2_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}); bound / device "
          f"{bound_ms / erf_ms:.1%} (v2 {bound_ms / v2_ms:.1%}) (20 calls, warm L2; {card})")
    k4 = {"gelu_device_ms_32768": erf_ms, "gelu_v2_device_ms_32768": v2_ms,
          "gelu_bound_ms_32768": bound_ms, "gelu_max_abs_err": err,
          "crossover_sweep": mlp_crossover_sweep(M, g, card)}
    del x, args, got
    torch.cuda.empty_cache()

    model = sam.SamViTB(dtype=torch.bfloat16, use_kernels=True).init_weights(
        torch.Generator().manual_seed(0)).to("cuda").eval()
    images = torch.rand(8, 1024, 1024, 3, generator=g, device="cuda")
    clicks = torch.tensor([[[512.0, 512.0, 1.0]]], device="cuda").expand(8, 1, 3)
    before = (R.LAUNCHES, M.LAUNCHES, M.MANY_TOKEN_LAUNCHES)
    with torch.no_grad():
        masks, iou = model(images, clicks)
    torch.cuda.synchronize()
    launches = (R.LAUNCHES - before[0], M.LAUNCHES - before[1])
    many = M.MANY_TOKEN_LAUNCHES - before[2]
    print(f"[kernels] SamViTB forward at micro-batch 8: K5 {launches[0]} launches, K4 "
          f"{launches[1]}, {many} of them v3 (12 blocks: 8 windowed, 4 global); masks "
          f"{tuple(masks.shape)} finite "
          f"{bool(torch.isfinite(masks).all() and torch.isfinite(iou).all())}")
    if launches != (12, 12) or many != 12 or not torch.isfinite(masks).all():
        raise AssertionError(f"SamViTB forward: launches {launches} ({many} v3), want (12, "
                             f"12) all v3, or non-finite masks")
    del model, images, masks
    torch.cuda.empty_cache()
    return k5, k4, launches


def phase_kernels(A, M, D, card: str) -> dict:
    fastmath_gap(card)
    op_dispatch_us(A, M, D, card)
    return {"fused_attention": phase_attention(A, card), "fused_mlp": phase_mlp(M, card),
            "fused_mlp_partial": phase_mlp_partial(M, card),
            "fused_double_conv": phase_double_conv(D, card)}


# The batch sizes the serving paths run: one request, and the
# BatchingEngine's buckets at max_batch 8.
BATCHES = (1, 2, 4, 8)


def unet64_levels(side: int, cin: int):
    """The nine double convs of one UNet-64 forward at `side` px, in order
    (stem, down 2-5, up 1-4), as (side, Cin, Cout)."""
    return ((side, cin, 64), (side // 2, 64, 128), (side // 4, 128, 256),
            (side // 8, 256, 512), (side // 16, 512, 1024), (side // 8, 1024, 512),
            (side // 4, 512, 256), (side // 2, 256, 128), (side, 128, 64))


def sp_slab_levels(side: int, cin: int, shards: int):
    """The haloed slabs K1 runs on in the SP eval forward of a UNet-64 at
    `side` px over `shards` shards of H (ops/kernels/blocks.py `haloed`):
    (rows, width, Cin, Cout, up level?) for each level and each distinct
    slab height, H_local + 2 at the image's top or bottom edge and
    H_local + 4 inside."""
    out = []
    for i, (h, ci, c) in enumerate(unet64_levels(side, cin)):
        local = h // shards
        for rows in sorted({local + 2} | ({local + 4} if shards > 2 else set())):
            out.append((rows, h, ci, c, i >= 5))
    return out


# The SP eval forward's slabs: phase 16 (c) at 2 shards and its four-card
# run (`four_cards`) at 4, the UNet-64 at 256 px, B 8.
SP_SLABS = [(8,) + lv for shards in (2, 4) for lv in sp_slab_levels(256, 3, shards)]
# K1 at every shape the served paths give it: the unet family at 256 px and
# the prompt model's selection UNet at 224 px (a Cin = 4 stem, a ragged 14²
# deepest level), each at every batch size; then the SP slabs' down levels;
# then a ragged shape with bias1 = +1.
K1_CASES = [((n, h, h, cin), c, 0.0) for n in BATCHES
            for side, cin0 in ((256, 3), (224, 4))
            for h, cin, c in unet64_levels(side, cin0)] + [
    ((n, rows, w, cin), c, 0.0) for n, rows, w, cin, c, up in SP_SLABS if not up] + [
    ((1, 37, 45, 24), 72, 1.0)]
# The shapes phase 3 times: both UNets' nine levels at one request and at
# the largest batch.
K1_TIMED = [(n, side, cin0) for n in (1, 8) for side, cin0 in ((256, 3), (224, 4))]
# The up blocks' double conv with the concat in the load stage: the four up
# levels of the 256 px UNet-64 (skip and up halves of Cin), the SP slabs'
# up levels, then channel counts off the 64-channel K step on a ragged
# image.
K1_CAT_CASES = [((1, h, h), cin // 2, cin // 2, c) for h, cin, c in unet64_levels(256, 3)[5:]] + [
    ((n, rows, w), cin // 2, cin // 2, c) for n, rows, w, cin, c, up in SP_SLABS if up] + [
    ((2, 37, 45), 24, 48, 72)]


def _is_library_conv(kernel: str) -> bool:
    """A device row of cuDNN's (or CUTLASS's) conv kernels: none of PyTorch's
    own kernels (at::native) and no copy or memset."""
    return "at::native" not in kernel and not kernel.startswith(("Memcpy", "Memset"))


def _k1_args(g, xshape, c, b1_offset):
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    cin = xshape[-1]
    x = rnd(*xshape).bfloat16()
    w1 = (rnd(3, 3, cin, c) * (2 / (9 * cin)) ** 0.5).bfloat16()
    w2 = (rnd(3, 3, c, c) * (2 / (9 * c)) ** 0.5).bfloat16()
    return (x, w1, 1 + 0.1 * rnd(c), 0.1 * rnd(c) + b1_offset, w2, 1 + 0.1 * rnd(c),
            0.1 * rnd(c))


def library_double_conv(args):
    """The library chain of the same function: cuDNN's conv (F.conv2d, bf16,
    channels_last) -> * scale + bias -> ReLU, twice; returns a callable."""
    import torch.nn.functional as F

    x, w1, s1, b1, w2, s2, b2 = args
    ws = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) for w in (w1, w2)]
    sb = [(s.bfloat16().view(1, -1, 1, 1), b.bfloat16().view(1, -1, 1, 1))
          for s, b in ((s1, b1), (s2, b2))]
    xc = x.permute(0, 3, 1, 2)

    def chain():
        y = xc
        for w, (s, b) in zip(ws, sb):
            y = torch.addcmul(b, F.conv2d(y, w, padding=1), s).relu_()
        return y

    return chain


def check_double_conv(D, g, cases, cat_cases) -> list:
    """K1 at `cases` and its concat entry at `cat_cases` (in K1_CASES' and
    K1_CAT_CASES' form) against the plain versions, each also bit-equal
    over two calls; returns the max abs errors."""
    errs = []
    for xshape, c, b1_offset in cases:
        args = _k1_args(g, xshape, c, b1_offset)
        got = D.fused_double_conv(*args)
        torch.cuda.synchronize()
        errs.append(_compare(f"double_conv {xshape}->{c} bias1+{b1_offset}", got,
                             D.double_conv_reference(*args)))
        if not torch.equal(got, D.fused_double_conv(*args)):
            raise AssertionError(f"double_conv {xshape}->{c}: two calls differ")
    for nhw, cs, cu, c in cat_cases:
        x, *w = _k1_args(g, nhw + (cs + cu,), c, 1.0)
        skip, up = x[..., :cs].contiguous(), x[..., cs:].contiguous()
        got = D.fused_double_conv_cat(skip, up, *w)
        torch.cuda.synchronize()
        errs.append(_compare(f"double_conv concat {nhw} skip {cs} + up {cu} -> {c}", got,
                             D.double_conv_cat_reference(skip, up, *w)))
        if not torch.equal(got, D.fused_double_conv_cat(skip, up, *w)):
            raise AssertionError(f"double_conv concat {nhw}: two calls differ")
    return errs


def phase_double_conv(D, card: str) -> dict:
    """K1 (and its concat entry) against the plain versions at every served
    shape, two calls bit for bit; then the nine levels of both UNets at
    N = 1 and 8: device time (torch.profiler) and time from Python, the
    bound, cuDNN's conv kernels alone and the whole library chain."""
    g = torch.Generator(device="cuda").manual_seed(1)
    errs = check_double_conv(D, g, K1_CASES, K1_CAT_CASES)
    print(f"[kernels] double_conv: {len(K1_CASES)} shapes and the concat entry within "
          f"tolerance, every one bit-equal over two calls")

    keys = ("device_ms", "ms", "bound_ms", "cudnn_conv_ms", "chain_ms")
    sums = {}
    for n, side, cin0 in K1_TIMED:
        total = dict.fromkeys(keys, 0.0)
        for h, cin, c in unet64_levels(side, cin0):
            args = _k1_args(g, (n, h, h, cin), c, 0.0)
            kernel = lambda: D.fused_double_conv(*args)  # noqa: E731
            rows = _device_profile(library_double_conv(args))
            row = {"device_ms": _device_ms(kernel), "ms": _cuda_ms(kernel),
                   "bound_ms": double_conv_bound(n, h, h, cin, c)[0],
                   "cudnn_conv_ms": sum(v for k, v in rows.items() if _is_library_conv(k)),
                   "chain_ms": sum(rows.values())}
            for key in keys:
                total[key] += row[key]
            print(f"[kernels] double_conv N={n} {h}x{h} {cin}->{c}: device {row['device_ms']:.4f} "
                  f"ms, from Python {row['ms']:.4f} ms; bound {row['bound_ms']:.5f} ms; cuDNN "
                  f"conv kernels {row['cudnn_conv_ms']:.4f} ms, conv->scale+bias->ReLU x2 chain "
                  f"{row['chain_ms']:.4f} ms; device / bound "
                  f"{row['device_ms'] / row['bound_ms']:.2f}, device / cuDNN convs "
                  f"{row['device_ms'] / row['cudnn_conv_ms']:.2f} (20 calls, warm L2; {card})")
        sums[n, side] = total
        print(f"[kernels] double_conv, the nine levels of one {side} px UNet-64 (Cin {cin0}) "
              f"at N={n} summed: device {total['device_ms']:.4f} ms, from Python "
              f"{total['ms']:.4f} ms, bound {total['bound_ms']:.5f} ms, cuDNN conv kernels "
              f"{total['cudnn_conv_ms']:.4f} ms, library chain {total['chain_ms']:.4f} ms ({card})")
    one = sums[1, 256]
    plain_ms = sum(_cuda_ms(lambda a=_k1_args(g, (1, h, h, cin), c, 0.0):
                            D.double_conv_reference(*a), iters=5)
                   for h, cin, c in unet64_levels(256, 3))
    sides = {"bytes": 0.0, "operations": 0.0}  # the side that sets most of the summed bound
    for h, cin, c in unet64_levels(256, 3):
        ms, side = double_conv_bound(1, h, h, cin, c)
        sides[side] += ms
    return {"ms": one["ms"], "device_ms": one["device_ms"], "plain_ms": plain_ms,
            "bound_ms": one["bound_ms"], "bound_by": max(sides, key=sides.get),
            "library_ms": one["cudnn_conv_ms"], "library_chain_ms": one["chain_ms"],
            "device_ms_n8": sums[8, 256]["device_ms"],
            "library_ms_n8": sums[8, 256]["cudnn_conv_ms"],
            "at": "the nine levels of one 256 px UNet-64 request, summed; library_ms is "
                  "cuDNN's conv kernels alone for the same 18 convs",
            "max_abs_err": max(errs)}


def clip_forward_device_ms(model, x1: torch.Tensor, batches=(1, 8)) -> dict:
    """Device ms of one full-width ClipUNet forward at each batch size:
    x1 (1, 224, 224, 3) repeated to the batch."""
    out = {}
    with torch.inference_mode():
        for b in batches:
            xb = x1.expand(b, *x1.shape[1:]).contiguous()
            out[b] = _device_ms(lambda: model(xb), iters=5)
    return out


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
    dev = clip_forward_device_ms(model, x)
    print(f"[serve] full-width ClipUNet forward, device time (torch.profiler, 5 calls): "
          f"batch 1 {dev[1]:.4f} ms, batch 8 {dev[8]:.4f} ms ({card})")
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
    unet_forward_device(model, plain, x, card)
    return launches, model


def unet_forward_device(model, plain, x1: torch.Tensor, card: str) -> None:
    """Device time of the full-width UNet forward through K1 and through the
    module path (cuDNN conv -> BN -> ReLU) at batch 1 and 8, beside its
    bound; the K1 forward's device time split into K1's kernels, cuDNN's
    (the transpose convs and the head) and PyTorch's own (pools, weight
    casts and BN folding, copies)."""
    with torch.inference_mode():
        for b in (1, 8):
            xb = x1.expand(b, *x1.shape[1:]).contiguous()
            rows = _device_profile(lambda: model(xb), iters=5)
            split = {"K1": 0.0, "cuDNN": 0.0, "PyTorch": 0.0}
            for k, v in rows.items():
                kind = ("K1" if "conv3x3_kernel" in k or "splitk_epilogue" in k
                        else "cuDNN" if _is_library_conv(k) else "PyTorch")
                split[kind] += v
            module = _device_ms(lambda: plain(xb), iters=5)
            bound = unet_forward_bound(b, x1.shape[1], x1.shape[-1])
            print(f"[unet] full-width UNet forward at batch {b}, device time (torch.profiler, 5 "
                  f"calls): through K1 {sum(rows.values()):.4f} ms "
                  f"{ {k: round(v, 4) for k, v in split.items()} }, module path (cuDNN) "
                  f"{module:.4f} ms; bound: forward {bound['forward']:.5f} ms, K2's eight "
                  f"blocks {bound['k2']:.5f} ms, K1's nine double convs {bound['k1']:.5f} ms "
                  f"({card})")


KERNEL_NAMES = ("fused_attention", "fused_mlp", "fused_double_conv")


def _counts(K) -> tuple:
    return tuple(k.LAUNCHES for k in K)


def _zero(K) -> None:
    for k in K:
        k.LAUNCHES = 0


def _add(launches: dict, K) -> None:
    """Add the counts of the path just driven to the totals."""
    _add_counts(launches, _counts(K))


def _add_counts(launches: dict, counts) -> None:
    for name, n in zip(KERNEL_NAMES, counts):
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


def _eval_batches(n_val: int, seed: int, batch: int = 8, prompt: bool = False) -> int:
    """The eval batches of one device-protocol epoch over run.py's
    synthetic val set (its prompt triplets, seeded as run.py seeds them,
    with `prompt`): its canvas-size buckets, each cut into batches."""
    from image_segmentation_tpu_torch.data.dataset import ArrayDataset
    from image_segmentation_tpu_torch.data.prompts import generate_prompt_dataset
    from image_segmentation_tpu_torch.run import _synthetic_items
    from image_segmentation_tpu_torch.train.fast_eval import plan_size_buckets

    items = _synthetic_items(n_val, seed)
    if prompt:
        items = generate_prompt_dataset(ArrayDataset(items), seed=seed).items
    labels = [item[-1] for item in items]
    plan = plan_size_buckets(labels) if len(labels) >= 16 else [range(len(labels))]
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


def phase_training(K, launches: dict, card: str, models_dir: str) -> None:
    """unet_noaug training on the card: the full-width fit through run.py
    and a resume (its MO_ kept in `models_dir` for phase 13), a
    bf16-vs-f32 step at narrow width, the trainer's eval through K1 against
    the module path, and the train step's throughput."""
    import os
    import shutil
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
        shutil.copytree(os.path.join(tmp, "MO_unet_noaug"),
                        os.path.join(models_dir, "MO_unet_noaug"))

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
    batch = cfg.batch_size * cfg.accum_steps
    x, y = _full_batch(batch)
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


def _step_ms(step, iters: int = 10) -> float:
    """Median ms of one train step (CUDA events), after 2 warm-up steps."""
    return _cuda_ms(step, iters=iters, warmup=2)


def _syncs(fn) -> int:
    """How many times one fn() call makes the host wait on the card: the
    warnings of torch.cuda's sync debug mode, after a warm-up call."""
    import warnings

    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def _full_batch(batch: int, side: int = 256, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (batch, side, side, 3)).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 4, (batch, side, side))).cuda()
    return x, y


def augment_device_ms(card: str) -> dict:
    """Device ms of the online augmentation on a 64-row 256 px batch from
    torch.profiler: each augmenter applied to all 64 rows, and
    random_augment_batch (draws and grouped apply) as the trainer calls it."""
    from image_segmentation_tpu_torch.ops import augment as Aug

    x, y = _full_batch(64, seed=3)
    gen = torch.Generator().manual_seed(0)
    params = Aug.draw_augment_params(64, 256, gen, "cuda")
    out = {name: _device_ms(lambda fn=fn: fn(x, y, params), iters=10)
           for name, fn in Aug.AUGMENTERS}
    # the trainer's call: the draws depend on the generator's state and the
    # launches on the draws, so every timed call restarts the same seed
    reseeded = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    out["draws"] = _device_ms(lambda: Aug.draw_augment_params(64, 256, reseeded(), "cuda"),
                              iters=10)
    out["random_augment_batch"] = _device_ms(
        lambda: Aug.random_augment_batch(x, y, reseeded()), iters=10)
    print(f"[aug] device ms on a (64, 256, 256, 3) batch, torch.profiler: "
          f"{ {k: round(v, 4) for k, v in out.items()} } ({card})")
    return out


def phase_unet_aug(K, launches: dict, card: str) -> None:
    """unet_aug on the card: run.main with online augmentation for 2 epochs
    and a 1-epoch --offline-aug run (K1 in every eval epoch), the changed
    share of each step batch, the step with and without augmentation, and
    the augmentation's device time."""
    import tempfile

    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch import run as R
    from image_segmentation_tpu_torch.ops import augment as Aug
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import train_step

    cfg = C.UNET_AUG
    n_train, n_val = 128, 32
    per_epoch = 9 * _eval_batches(n_val, cfg.seed + 1, cfg.batch_size)
    changed = []
    real = Aug.random_augment_batch

    def spy(images, labels, generator):
        out = real(images, labels, generator)
        rows = (out[0] != images).flatten(1).any(1) | (out[1] != labels).flatten(1).any(1)
        changed.append(float(rows.float().mean()))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--config", "unet_aug", "--save-dir", tmp, "--device", "cuda"]
        Aug.random_augment_batch = spy
        try:
            _zero(K)
            t0 = time.time()
            res = R.main(argv + ["--synthetic", str(n_train), "--epochs", "2"])
            fit_s = time.time() - t0
            counts = _counts(K)
            _add(launches, K)
        finally:
            Aug.random_augment_batch = real
        losses = res.history["train_loss"]
        print(f"[unet_aug] fit 2 epochs, {n_train} train / {n_val} val synthetic images at "
              f"256 px, micro 8 x accum 8, online augmentation: {fit_s:.1f} s; train loss "
              f"{losses}; changed rows per step batch {changed}; launches (attention, mlp, "
              f"double_conv) {counts}, want (0, 0, {2 * per_epoch}) ({card})")
        if not all(np.isfinite(losses)) or counts != (0, 0, 2 * per_epoch):
            raise AssertionError(f"unet_aug fit: losses {losses}, launches {counts}")
        # p_augment 0.5 over 64 rows: 0.5 ± 0.0625 (one standard deviation)
        if len(changed) != 4 or not all(0.25 <= c <= 0.75 for c in changed):
            raise AssertionError(f"augmented share of the step batches {changed}")
        _zero(K)
        t0 = time.time()
        res = R.main(argv + ["--synthetic", "16", "--epochs", "1", "--offline-aug",
                             "--save-dir", tmp + "/offline"])
        counts = _counts(K)
        _add(launches, K)
        want = 9 * _eval_batches(4, cfg.seed + 1, cfg.batch_size)
        print(f"[unet_aug] --offline-aug, 16 synthetic items expanded on the host, 1 epoch: "
              f"{time.time() - t0:.1f} s; {res.state.step} steps; train loss "
              f"{res.history['train_loss']}; launches {counts}, want (0, 0, {want}) ({card})")
        if not np.isfinite(res.history["train_loss"][0]) or counts != (0, 0, want):
            raise AssertionError(f"offline unet_aug: {res.history}, launches {counts}")

    # the step at full width with and without augmentation, in turns
    model = C.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    st = TrainState(model, *C.build_optimizer(cfg, model))
    x, y = _full_batch(cfg.batch_size * cfg.accum_steps)
    loss_fn = C.build_loss(cfg)
    gen = torch.Generator().manual_seed(0)
    plain = lambda: train_step(st, loss_fn, x, y, cfg.accum_steps)  # noqa: E731
    aug = lambda: train_step(st, loss_fn, x, y, cfg.accum_steps, Aug.random_augment_batch,  # noqa
                             gen)
    # the calls that make the host wait on the card: none in the
    # augmentation, and no more in the augmented step than in the plain one
    syncs = {"random_augment_batch": _syncs(lambda: Aug.random_augment_batch(x, y, gen)),
             "plain step": _syncs(plain), "augmented step": _syncs(aug)}
    print(f"[unet_aug] calls that wait on the card (torch.cuda sync debug mode): {syncs}")
    if syncs["random_augment_batch"] or syncs["augmented step"] != syncs["plain step"]:
        raise AssertionError(f"the online augmentation waits on the card: {syncs}")
    # four steps in turns, forward and reversed: plain, augmented, a plain
    # step on an already augmented batch (does the data move the step?),
    # and the augmentation's call followed by a plain step (its launches)
    xa, ya = Aug.random_augment_batch(x, y, torch.Generator().manual_seed(7))
    steps = {"plain": plain, "augmented": aug,
             "pre-augmented": lambda: train_step(st, loss_fn, xa, ya, cfg.accum_steps),
             "call then plain": lambda: (Aug.random_augment_batch(x, y, gen), plain())}
    times = {k: [] for k in steps}
    for turn in range(4):
        for k in (list(steps) if turn % 2 == 0 else list(steps)[::-1]):
            times[k].append(round(_step_ms(steps[k], iters=10), 3))
    medians = {k: round(statistics.median(v), 3) for k, v in times.items()}
    print(f"[unet_aug] train step, UNet base 64, 256 px, batch 64 (8 x 8), bf16, median of 10 "
          f"(CUDA events) in 4 turns, forward and reversed: {times} ms; medians {medians}; "
          f"augmented - plain {medians['augmented'] - medians['plain']:.3f} ms ({card})")
    # device ms a step: every CUDA row of 2 steps under torch.profiler over
    # 2 (one session each; a profiled step costs seconds of host time). The
    # augmented steps' kernels change with the draws, so sessions cannot be
    # held to equal counts as `_device_profile` holds them
    dev = {}
    for name, fn in (("plain", plain), ("augmented", aug)):
        fn()
        dev[name] = round(sum(t for _, t in _profile_session(fn, 2).values()) / 2e3, 3)
    print(f"[unet_aug] the same steps' device ms (torch.profiler, 2 steps): {dev} ({card})")
    # the call the augmented step adds, alone: its launches and its kernels
    # (CUDA events around each call)
    call_ms = _cuda_ms(lambda: Aug.random_augment_batch(x, y, gen), iters=20)
    print(f"[unet_aug] random_augment_batch on the 64-row batch: median {call_ms:.3f} ms a call "
          f"(CUDA events, the host's enqueue included) ({card})")
    augment_device_ms(card)
    print(f"[unet_aug] K1 launches so far on the main paths: {launches['fused_double_conv']}")


def phase_autoencoder(K, launches: dict, card: str, models_dir: str) -> None:
    """The two-stage autoencoder on the card: recon_ae for 2 epochs through
    run.main, then autoencoder --pretrained-encoder for 2 (its MO_ kept in
    `models_dir` for phase 13); the encoder as transferred and as left by
    the frozen stage 2; each stage's step."""
    import os
    import shutil
    import tempfile

    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch import run as R
    from image_segmentation_tpu_torch.train import checkpoint as ckpt
    from image_segmentation_tpu_torch.train.loop import mse_loss
    from image_segmentation_tpu_torch.train.state import TrainState, freeze_, make_adamw
    from image_segmentation_tpu_torch.train.steps import train_step

    n_train = 128
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--synthetic", str(n_train), "--epochs", "2", "--save-dir", tmp,
                  "--device", "cuda"]
        _zero(K)
        t0 = time.time()
        recon = R.main(["--config", "recon_ae"] + common)
        t1 = time.time()
        src = os.path.join(tmp, "recon_ae")
        seg = R.main(["--config", "autoencoder", "--pretrained-encoder", src] + common)
        t2 = time.time()
        counts = _counts(K)
        _add(launches, K)
        print(f"[ae] recon_ae 2 epochs {t1 - t0:.1f} s, train mse {recon.history['train_loss']}, "
              f"val mse (original size) {recon.history['val_loss']}; autoencoder 2 epochs "
              f"{t2 - t1:.1f} s, train loss {seg.history['train_loss']}, val mIoU "
              f"{seg.history['val_iou']}; launches {counts} (no kernel on this path) ({card})")
        losses = recon.history["train_loss"] + seg.history["train_loss"]
        if not all(np.isfinite(losses)) or counts != (0, 0, 0):
            raise AssertionError(f"autoencoder stages: losses {losses}, launches {counts}")
        want = ckpt.load_model_state(src, "cuda")
        fresh = C.build_model(C.AUTOENCODER, "cuda", torch.Generator().manual_seed(5))
        n = ckpt.load_subtree(src, fresh, "encoder", "encoder")
        got = fresh.state_dict()
        after = seg.state.model.state_dict()
        enc = [k for k in want if k.startswith("encoder.")]
        transferred = all(torch.equal(got[k], want[k]) for k in enc)
        kept = all(torch.equal(after[k], want[k]) for k in enc if "running" not in k)
        moved = sum(not torch.equal(after[k], want[k]) for k in enc if "running" in k)
        print(f"[ae] encoder: {n} entries transferred, equal to the recon checkpoint's "
              f"{transferred}; parameters unchanged after the frozen stage 2 {kept}; BN "
              f"statistics moved {moved} of {sum('running' in k for k in enc)}")
        if not (transferred and kept and moved):
            raise AssertionError("the encoder transfer or freeze does not hold")
        shutil.copytree(os.path.join(tmp, "MO_autoencoder"),
                        os.path.join(models_dir, "MO_autoencoder"))

    x, _ = _full_batch(64, seed=4)
    _, y = _full_batch(64, seed=5)
    model = C.build_model(C.RECON_AE, "cuda", torch.Generator().manual_seed(0))
    st = TrainState(model, make_adamw(model.parameters(), weight_decay=0.0)[0])
    recon_ms = _step_ms(lambda: train_step(st, mse_loss, x, x, 8))
    model = C.build_model(C.AUTOENCODER, "cuda", torch.Generator().manual_seed(0))
    freeze_(model, ("encoder",))
    st = TrainState(model, *C.build_optimizer(C.AUTOENCODER, model,
                                              frozen_prefixes=("encoder",)))
    loss_fn = C.build_loss(C.AUTOENCODER)
    seg_ms = _step_ms(lambda: train_step(st, loss_fn, x, y, 8))
    print(f"[ae] train step, base 64, 256 px, batch 64 (8 x 8), bf16, median of 10 (CUDA "
          f"events): recon_ae {recon_ms:.3f} ms, autoencoder (frozen encoder) {seg_ms:.3f} ms; "
          f"recon best val mse {recon.best['loss']:.6f} ({card})")


# The CLIP steps' device time by kind: the ViT's two kernels first (K4's
# reduction before the generic reductions), then phase 8's kinds, whose
# GEMM group here also holds cuBLAS's linear layers.
CLIP_STEP_KINDS = ((("K3", ("attention_kernel",)),
                    ("K4", ("mlp_fc1_kernel", "mlp_fc2_kernel", "mlp_reduce_kernel")))
                   + tuple((("GEMM and conv (cuBLAS, cuDNN)" if k == "conv (cuDNN)" else k), w)
                           for k, w in STEP_KERNEL_KINDS))


def _step_report(step, batch: int) -> dict:
    """A train step's median ms of 10 (CUDA events, after 2 warm-up
    steps), images/s, peak device memory, and its device ms under
    torch.profiler (2 steps), by kind too, with the share of the
    unprofiled step that the device is busy."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = _cuda_ms(step, iters=10, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    rows = _profile_session(step, 2)
    device_ms = sum(t for _, t in rows.values()) / 2e3
    kinds = {}
    for key, (_, t) in rows.items():
        kind = next((k for k, words in CLIP_STEP_KINDS if any(w in key for w in words)), "other")
        kinds[kind] = round(kinds.get(kind, 0.0) + t / 2e3, 3)
    return {"ms": round(ms, 3), "images/s": round(batch / ms * 1e3, 1),
            "device ms": round(device_ms, 3), "busy": round(device_ms / ms, 4),
            "peak bytes": peak, "device ms by kind": kinds}


class _FirstLoss:
    """Wraps train.loop's train_step while a run lasts and keeps the loss of
    its first call: the first optimizer step's loss."""

    def __init__(self):
        from image_segmentation_tpu_torch.train import loop

        self.loop, self.real, self.losses = loop, loop.train_step, []

    def __enter__(self):
        def spy(*args, **kwargs):
            loss = self.real(*args, **kwargs)
            self.losses.append(loss)
            return loss

        self.loop.train_step = spy
        return self

    def __exit__(self, *exc):
        self.loop.train_step = self.real

    @property
    def first(self) -> float:
        return float(self.losses[0])


def _write_clip_npz(tmp: str, seed: int) -> str:
    """A seeded random full-width ViT saved as an HF-layout state dict,
    converted to the CLIP .npz by the port's converter; returns its path."""
    import os

    from image_segmentation_tpu_torch.models.clip_vit import ClipViT
    from image_segmentation_tpu_torch.utils import convert_clip_weights

    vit = ClipViT()
    vit.init_weights(torch.Generator().manual_seed(seed))
    pt, npz = os.path.join(tmp, "vit.pt"), os.path.join(tmp, "clip_vit_b16.npz")
    torch.save({f"vision_model.{k}": v for k, v in vit.state_dict().items()}, pt)
    if convert_clip_weights.main(["--torch-state-dict", pt, "--out", npz]) != 0:
        raise AssertionError("the CLIP weight converter failed")
    return npz


def phase_clip_training(K, launches: dict, card: str, tmp: str) -> str:
    """clipunet and clipunet_noskips at full width (ViT-B/16, decoder
    1024..64, 224 px, bf16, K3/K4 on) through run.main: clipunet for 2
    epochs on 128 synthetic images with --clip-weights from a converted
    random ViT, the same run with --cache-features, clipunet_noskips for 1;
    then the in-line and the cached step and the encode. Returns the
    in-line run's MO_ directory."""
    import os

    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch import run as R
    from image_segmentation_tpu_torch.models.clip_vit import load_pretrained_clip_state
    from image_segmentation_tpu_torch.train import feature_cache as FC
    from image_segmentation_tpu_torch.train.state import TrainState, freeze_
    from image_segmentation_tpu_torch.train.steps import train_step

    cfg = C.CLIPUNET
    n_train, n_val, epochs = 128, 32, 2
    micro_fwd = epochs * (n_train // (cfg.batch_size * cfg.accum_steps)) * cfg.accum_steps
    encode = -(-n_train // cfg.batch_size)
    eval_b = _eval_batches(n_val, cfg.seed + 1, cfg.batch_size)
    npz = _write_clip_npz(tmp, seed=11)
    want_vit = load_pretrained_clip_state(npz)
    runs = {}
    for name, extra, want in (
            ("in line", [], 12 * (micro_fwd + epochs * eval_b)),
            ("cached", ["--cache-features"], 12 * (encode + epochs * eval_b))):
        _zero(K)
        t0 = time.time()
        with _FirstLoss() as first:
            res = R.main(["--config", "clipunet", "--synthetic", str(n_train), "--epochs",
                          str(epochs), "--clip-weights", npz, "--device", "cuda",
                          "--save-dir", os.path.join(tmp, name.replace(" ", "_"))] + extra)
        counts = _counts(K)
        _add(launches, K)
        runs[name] = first.first
        losses = res.history["train_loss"]
        full = res.state.model if name == "in line" else None
        print(f"[clip] clipunet {name}, {epochs} epochs, {n_train} train / {n_val} val "
              f"synthetic images at 224 px, micro 8 x accum 8: {time.time() - t0:.1f} s; "
              f"step 1 loss {first.first!r}; train loss {losses}; val mIoU "
              f"{res.history['val_iou']}; launches (attention, mlp, double_conv) {counts}, "
              f"want ({want}, {want}, 0) ({card})")
        if not all(np.isfinite(losses)) or counts != (want, want, 0):
            raise AssertionError(f"clipunet {name}: losses {losses}, launches {counts}")
        mo = os.path.join(tmp, name.replace(" ", "_"), "MO_clipunet")
        saved = torch.load(os.path.join(mo, "weights.pt"), map_location="cpu")
        vit_equal = all(torch.equal(saved[f"vision_model.{k}"], v) for k, v in want_vit.items())
        if full is not None:
            vit_equal &= all(torch.equal(v.cpu(), want_vit[k])
                             for k, v in full.vision_model.state_dict().items())
        print(f"[clip] {name}: the run's ViT and its MO_'s equal the converted .npz "
              f"{vit_equal}; MO_ entries {len(saved)}")
        if not vit_equal:
            raise AssertionError(f"clipunet {name}: the ViT is not the --clip-weights ViT")
    print(f"[clip] step 1 loss, in line {runs['in line']!r}, cached {runs['cached']!r}")
    if runs["in line"] != runs["cached"]:
        raise AssertionError(f"step 1 losses differ: {runs}")

    _zero(K)
    t0 = time.time()
    res = R.main(["--config", "clipunet_noskips", "--synthetic", str(n_train), "--epochs", "1",
                  "--device", "cuda", "--save-dir", os.path.join(tmp, "noskips")])
    counts = _counts(K)
    _add(launches, K)
    want = 12 * (micro_fwd // epochs + eval_b)
    print(f"[clip] clipunet_noskips 1 epoch: {time.time() - t0:.1f} s; train loss "
          f"{res.history['train_loss']}; launches {counts}, want ({want}, {want}, 0) ({card})")
    if not np.isfinite(res.history["train_loss"][0]) or counts != (want, want, 0):
        raise AssertionError(f"clipunet_noskips: {res.history}, launches {counts}")

    # the step at batch 64 (8 x 8), in line and on cached features, and
    # the encode
    model = C.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    freeze_(model, ("vision_model",))
    loss_fn = C.build_loss(cfg)
    x, y = _full_batch(64, side=224, seed=6)
    st = TrainState(model, *C.build_optimizer(cfg, model, frozen_prefixes=("vision_model",)))
    inline = _step_report(lambda: train_step(st, loss_fn, x, y, 8), 64)
    images = x.cpu().numpy()
    FC.encode_clip_features(model, images[:8], batch_size=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = FC.encode_clip_features(model, images, batch_size=8)
    encode_ms = (time.perf_counter() - t0) * 1e3
    x8 = x[:8]
    with torch.no_grad():
        encode_dev = _device_ms(lambda: model.encode(x8), iters=5) / 8
    dev_feats = torch.from_numpy(feats).cuda()
    decoder = model.decoder_only()
    sd = TrainState(decoder, *C.build_optimizer(cfg, decoder))
    cached = _step_report(lambda: train_step(sd, loss_fn, dev_feats, y, 8), 64)
    print(f"[clip] train step, full width, batch 64 (8 x 8), bf16: in line {inline}; on "
          f"cached features {cached}; encode {encode_ms / 64:.3f} ms an image (64 images in "
          f"batches of 8, host to host, {feats.nbytes} bytes of float32 features), of which "
          f"the ViT's device time {encode_dev:.4f} ms an image (torch.profiler, batch 8) "
          f"({card})")
    print(f"[clip] the card's total memory {torch.cuda.get_device_properties(0).total_memory} "
          f"bytes; default train-set budget (a quarter) "
          f"{torch.cuda.get_device_properties(0).total_memory // 4} bytes")
    return os.path.join(tmp, "in_line", "MO_clipunet")


def phase_prompt_training(K, launches: dict, card: str, clipunet_mo: str, tmp: str) -> None:
    """prompt at full width through run.main, its clip branch grafted from
    phase 11's ClipUNet: 1 epoch on the triplets of 64 synthetic images;
    the graft, the frozen ViT and the launches; then the step's ms."""
    import os

    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch import run as R
    from image_segmentation_tpu_torch.data.dataset import ArrayDataset
    from image_segmentation_tpu_torch.data.prompts import generate_prompt_dataset
    from image_segmentation_tpu_torch.train import checkpoint as ckpt
    from image_segmentation_tpu_torch.train.state import TrainState, freeze_
    from image_segmentation_tpu_torch.train.steps import train_step

    cfg = C.PROMPT
    n_images, n_val = 64, 16
    n_trip = len(generate_prompt_dataset(ArrayDataset(R._synthetic_items(n_images, cfg.seed)),
                                         seed=cfg.seed))
    want_clip = ckpt.load_model_state(clipunet_mo, "cuda")
    fresh = C.build_model(cfg, "cuda", torch.Generator().manual_seed(3))
    n = ckpt.load_subtree(clipunet_mo, fresh, "", "clip")
    got = fresh.state_dict()
    grafted = n == len(want_clip) and all(torch.equal(got[f"clip.{k}"], v)
                                          for k, v in want_clip.items())
    del fresh, got
    eval_b = _eval_batches(n_val, cfg.seed + 1, cfg.batch_size, prompt=True)
    _zero(K)
    t0 = time.time()
    res = R.main(["--config", "prompt", "--synthetic", str(n_images), "--epochs", "1",
                  "--clipunet-checkpoint", clipunet_mo, "--device", "cuda",
                  "--save-dir", os.path.join(tmp, "prompt")])
    counts = _counts(K)
    _add(launches, K)
    micro_fwd = (n_trip // (cfg.batch_size * cfg.accum_steps)) * cfg.accum_steps
    want = (12 * (eval_b + micro_fwd),) * 2 + (9 * eval_b,)
    after = res.state.model.state_dict()
    vit_kept = all(torch.equal(after[f"clip.{k}"], v) for k, v in want_clip.items()
                   if k.startswith("vision_model."))
    print(f"[prompt] prompt 1 epoch, {n_trip} train triplets, {eval_b} eval batches: "
          f"{time.time() - t0:.1f} s; train loss {res.history['train_loss']}; val mIoU "
          f"{res.history['val_iou']}; clip branch equal to the ClipUNet checkpoint after the "
          f"graft {grafted} ({n} entries); clip.vision_model unchanged by training "
          f"{vit_kept}; launches {counts}, want {want} ({card})")
    if not (np.isfinite(res.history["train_loss"][0]) and grafted and vit_kept
            and counts == want):
        raise AssertionError(f"prompt: {res.history}, graft {grafted}, ViT kept {vit_kept}, "
                             f"launches {counts} against {want}")
    model = C.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    freeze_(model, ("clip.vision_model",))
    st = TrainState(model, *C.build_optimizer(cfg, model, frozen_prefixes=("clip.vision_model",)))
    x, y = _full_batch(64, side=224, seed=8)
    hm = torch.rand(64, 224, 224, 1, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(8))
    rep = _step_report(lambda: train_step(st, C.build_loss(cfg), (x, hm), y, 8), 64)
    print(f"[prompt] train step, full width (freeze_clip False: the clip decoder and the "
          f"selection UNet train), batch 64 (8 x 8), bf16: {rep} ({card})")


FAMILIES = ("autoencoder", "clip", "prompt_model", "unet")


def _pct(xs, q: float) -> float:
    """The q-quantile of xs (nearest rank)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _png_every_filter(arr: np.ndarray) -> bytes:
    """(H, W) or (H, W, C) uint8 → PNG bytes whose rows use the five row
    filters in turn (PNG spec 9.2), as encoders that pick a filter per row
    (PIL, libpng, a browser's canvas) use them all; the port's own
    `encode_png` writes filter 0 only."""
    import struct
    import zlib

    from image_segmentation_tpu_torch.data import png

    px = arr.reshape(arr.shape[0], arr.shape[1], -1).astype(np.int32)
    bpp = px.shape[2]
    rows = []
    for y in range(px.shape[0]):
        line = px[y].reshape(-1)
        up = px[y - 1].reshape(-1) if y else np.zeros_like(line)
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        pred = (0, left, up, (left + up) >> 1, paeth)[y % 5]
        rows.append(bytes([y % 5]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes())
    color = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]  # gray, gray + alpha, RGB, RGBA
    ihdr = struct.pack(">IIBBBBB", px.shape[1], px.shape[0], 8, color, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(b"".join(rows), 6)) + png._chunk(b"IEND", b""))


def _synthetic_pngs(root: str, n: int, seed: int):
    """n images of mixed sizes and their class-id labels (0..2 and the 255
    boundary sentinel) as PNG files whose rows use every filter type, so
    that a host without PIL decodes them the slow way too."""
    import os

    rng = np.random.default_rng(seed)
    imgs, labels = os.path.join(root, "images"), os.path.join(root, "labels")
    os.makedirs(imgs)
    os.makedirs(labels)
    for i in range(n):
        h, w = int(rng.integers(96, 520)), int(rng.integers(96, 520))
        lab = rng.integers(0, 3, (h, w)).astype(np.uint8)
        img = (rng.uniform(0, 128, (h, w, 3)) + 60 * lab[..., None]).astype(np.uint8)
        lab[: h // 8] = 255
        with open(os.path.join(imgs, f"im{i:02d}.png"), "wb") as f:
            f.write(_png_every_filter(img))
        with open(os.path.join(labels, f"im{i:02d}.png"), "wb") as f:
            f.write(_png_every_filter(lab))
    return imgs, labels


def _decoder_name() -> str:
    """Which decoder `data/png.py` `decode` takes first on this host."""
    from image_segmentation_tpu_torch.data import png
    from image_segmentation_tpu_torch.ops import native_codec

    if native_codec.available():
        return "the native codec"
    return "PIL" if png.pil_available() else "the port codec, no PIL"


def phase_checkpoints(K, launches: dict, card: str, models_dir: str, tmp: str) -> None:
    """Serving what phases 8-12 trained, at full width, through the entry
    points users start: the --models-dir registry, the HTTP app with its
    frontend, predict.py, and the exported programs of serve/export.py."""
    import base64
    import os
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from image_segmentation_tpu_torch import predict as P
    from image_segmentation_tpu_torch.data import png
    from image_segmentation_tpu_torch.serve import app
    from image_segmentation_tpu_torch.serve import export as X
    from image_segmentation_tpu_torch.serve.engine import InferenceEngine, stage_request
    from image_segmentation_tpu_torch.serve.render import render_points

    # 1. the checkpoint registry on the card
    t0 = time.time()
    eng = app.build_engine_from_checkpoints(models_dir, "cuda")
    print(f"[ckpt] build_engine_from_checkpoints({sorted(os.listdir(models_dir))}) on cuda: "
          f"{eng.available()} in {time.time() - t0:.1f} s ({card})")
    if tuple(eng.available()) != FAMILIES:
        raise AssertionError(f"registry {eng.available()}, want {FAMILIES}")
    n = 12
    want = {"unet": (0, 0, 9), "autoencoder": (0, 0, 0), "clip": (n, n, 0),
            "prompt_model": (n, n, 9)}
    images = _images()

    def click(im):
        return render_points([{"x": im.shape[1] // 2, "y": im.shape[0] // 2}], im.shape[:2])

    warm = np.random.default_rng(99).uniform(0.0, 1.0, (300, 300, 3)).astype(np.float32)
    for name in FAMILIES:  # warm-up (cuDNN plans, allocator) on an image of its own
        eng.segment(warm, name, click(warm) if name == "prompt_model" else None)
    torch.cuda.synchronize()
    _zero(K)
    deltas = {}
    for name in FAMILIES:
        for im in images:
            pm = click(im) if name == "prompt_model" else None
            reqs = 2 if name == "prompt_model" else 1  # a first click, then a repeat
            for _ in range(reqs):
                before = _counts(K)
                out = eng.segment(im, name, pm)
                deltas.setdefault(name, []).append(
                    tuple(a - b for a, b in zip(_counts(K), before)))
                _check_mask(name, out["mask"], im.shape[:2])
    _add(launches, K)
    print(f"[ckpt] launches (attention, mlp, double_conv) per request at "
          f"{[im.shape[:2] for im in images]}: {deltas}")
    for name, got in deltas.items():
        expect = ([want[name], (0, 0, 9)] * len(images) if name == "prompt_model"
                  else [want[name]] * len(images))
        if got != expect:
            raise AssertionError(f"{name}: launches {got}, want {expect}")

    # the same state_dicts in models on the plain versions (module path UNet,
    # plain attention and MLP), in bf16 as served and in float32. A kernel
    # and its plain version agree within 2^-6 a call (phase 3), but a
    # model stacks 24 ViT kernel calls and a decoder on one residual
    # stream, and their bf16 roundings compound: the served scores are
    # held to the float32 forward, no farther from it than the plain
    # versions' bf16 forward is (relative L2, at most 1.5 times, the
    # bound phase 8 holds the bf16 train step to), and to the plain bf16
    # forward's argmax on >= 0.99 of the pixels.
    plain = InferenceEngine(device="cuda")
    exact = InferenceEngine(device="cuda", fast_transfer=False)
    for name in FAMILIES:
        path, cfg = app.find_checkpoint(models_dir, name)
        for target, f32 in ((plain, False), (exact, True)):
            model = app.load_family_model(
                path, dataclasses.replace(cfg, use_kernels=False), "cuda")
            for m in model.modules() if f32 else ():
                if isinstance(getattr(m, "dtype", None), torch.dtype):
                    m.dtype = torch.float32  # compute in f32 (TF32 is off, main())
            if name == "prompt_model":
                target.register_prompt_composed(name, model, eng.models[name].target_size)
            else:
                target.register(name, model, eng.models[name].target_size)
    rel_l2 = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    for name in FAMILIES:
        diffs, k_err, p_err, agree, total = [], [], [], 0, 0
        for im in images:
            inputs, _ = stage_request(im, eng.models[name],
                                      click(im) if name == "prompt_model" else None,
                                      eng.fast_transfer)
            batch = [a[None] for a in inputs]
            got = eng.forward(name, *batch)[0]
            ref = plain.forward(name, *batch)[0]
            f32 = exact.forward(name, *batch)[0]
            if not np.isfinite(got).all():
                raise AssertionError(f"{name}: scores not finite")
            diffs.append(float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30))
            k_err.append(rel_l2(got, f32))
            p_err.append(rel_l2(ref, f32))
            agree += int((got.argmax(-1) == ref.argmax(-1)).sum())
            total += got.shape[0] * got.shape[1]
        print(f"[ckpt] {name}: trained checkpoint, relative L2 to the f32 forward: kernels "
              f"{max(k_err):.4g}, plain versions in bf16 {max(p_err):.4g} (tol 1.5x); argmax "
              f"agreement with the plain bf16 forward {agree / total:.6f} of {total} pixels "
              f"(tol 0.99); max |kernels - plain| / max |plain| {max(diffs):.4g} "
              f"(2^-6 = {REL_TOL:.4g} a kernel call in phase 3)")
        if max(k_err) > 1.5 * max(p_err) or agree / total < 0.99:
            raise AssertionError(f"{name}: kernels {max(k_err)} vs plain {max(p_err)} from "
                                 f"f32, agreement {agree / total}")
    del plain, exact

    # 2. the HTTP app over the registry, in a thread on 127.0.0.1
    server = ThreadingHTTPServer(("127.0.0.1", 0), app.make_handler(eng))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            page = r.read()
        with open(os.path.join(app.TEMPLATE_DIR, "index.html"), "rb") as f:
            if page != f.read():
                raise AssertionError("GET / is not the template's bytes")
        with urllib.request.urlopen(base + "/static/script.js", timeout=60) as r:
            js = (r.status, len(r.read()))
        img = (images[0] * 255).astype(np.uint8)
        upload = _png_every_filter(img)
        body = {"image": base64.b64encode(upload).decode()}
        t = time.perf_counter()
        for _ in range(5):
            app.decode_base64_image(body["image"])
        upload_ms = (time.perf_counter() - t) / 5 * 1e3
        t = time.perf_counter()
        for _ in range(5):
            png.decode_png(upload)
        codec_ms = (time.perf_counter() - t) / 5 * 1e3
        codes = {}
        for name in FAMILIES:
            req = dict(body, model=name)
            if name == "prompt_model":
                req.update(prompt_type="bbox",
                           prompt_data={"x": 120, "y": 80, "width": 200, "height": 180})
            t = time.perf_counter()
            r = urllib.request.urlopen(urllib.request.Request(
                base + "/segment", data=json.dumps(req).encode(), method="POST",
                headers={"Content-Type": "application/json"}), timeout=120)
            out = json.loads(r.read())
            mask = png.decode(base64.b64decode(out["output_mask"]))
            codes[name] = (r.status, mask.shape, round((time.perf_counter() - t) * 1e3, 1))
            if r.status != 200 or mask.shape != img.shape:
                raise AssertionError(f"POST /segment {name}: {r.status}, mask {mask.shape}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    print(f"[ckpt] HTTP on 127.0.0.1: GET / = the template ({len(page)} bytes), GET "
          f"/static/script.js {js}; POST /segment of a {img.shape[1]}x{img.shape[0]} PNG whose "
          f"rows use every filter (status, mask shape, ms) {codes}; decoding that upload "
          f"({_decoder_name()}): {upload_ms:.1f} ms, "
          f"by the port codec (a host without PIL): {codec_ms:.1f} ms (host clock, mean of 5) "
          f"({card})")

    # 3. predict.py over 16 synthetic PNGs of mixed sizes, each family
    imgs, labels = _synthetic_pngs(os.path.join(tmp, "predict"), 16, seed=13)
    files = [os.path.join(d, f) for d in (imgs, labels) for f in sorted(os.listdir(d))]
    t = time.perf_counter()
    for f in files:
        with open(f, "rb") as fh:
            png.decode_png(fh.read())
    print(f"[ckpt] the port codec (a host without PIL) decodes predict's 16 images and 16 "
          f"labels in {(time.perf_counter() - t) * 1e3:.1f} ms (host clock) ({card})")
    for name in FAMILIES:
        _zero(K)
        argv = ["--models-dir", models_dir, "--input", imgs, "--labels", labels,
                "--output", os.path.join(tmp, "predict", name), "--model", name]
        summary = P.main(argv + (["--point", "48,48"] if name == "prompt_model" else []))
        counts = _counts(K)
        _add(launches, K)
        n_masks = len([f for f in os.listdir(os.path.join(tmp, "predict", name))
                       if f.endswith("_mask.png")])
        print(f"[ckpt] predict {name}: {summary['images']} PNGs whose rows use every filter "
              f"(decoded by {_decoder_name()}), "
              f"{n_masks} masks written, {summary['images_per_sec']} images/s after the "
              f"first; mIoU "
              f"{summary.get('mean_iou')} on synthetic labels (smoke weights: not a quality "
              f"number); launches {counts} ({card})")
        if n_masks != 16 or summary.get("scored") != 16 or counts != tuple(
                16 * c for c in want[name]):
            raise AssertionError(f"predict {name}: {summary}, launches {counts}")

    # 4. export the registry on the card, then serve the programs
    t0 = time.time()
    written = X.export_registry(models_dir, os.path.join(tmp, "exports"), device="cuda")
    print(f"[ckpt] export_registry on cuda: {len(written)} programs in "
          f"{time.time() - t0:.1f} s")
    aot = InferenceEngine(device="cuda")
    for path in written:
        t0 = time.perf_counter()
        name = aot.register_exported(path)
        print(f"[ckpt] exported {name}: {os.path.getsize(path)} bytes, loaded in "
              f"{time.perf_counter() - t0:.2f} s")
    for name in FAMILIES:  # warm-up
        aot.segment(warm, name, click(warm) if name == "prompt_model" else None)
    _zero(K)
    for name in FAMILIES:
        errs, agree, total, got_launches = [], 0, 0, []
        for im in images:
            pm = click(im) if name == "prompt_model" else None
            before = _counts(K)
            aot.segment(im, name, pm)
            got_launches.append(tuple(a - b for a, b in zip(_counts(K), before)))
            inputs, _ = stage_request(im, eng.models[name], pm, eng.fast_transfer)
            got = aot.forward(name, *(a[None] for a in inputs))[0]
            ref = eng.forward(name, *(a[None] for a in inputs))[0]
            errs.append(float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30))
            agree += int((got.argmax(-1) == ref.argmax(-1)).sum())
            total += got.shape[0] * got.shape[1]
        print(f"[ckpt] exported {name} vs the live engine: max |diff| / max |live| "
              f"{max(errs):.3g} (tol 2^-6); argmax agreement {agree / total:.6f}; launches "
              f"per segment() {got_launches}, the live path's first request {want[name]}")
        if max(errs) > REL_TOL or set(got_launches) != {want[name]}:
            raise AssertionError(f"exported {name}: {max(errs)}, launches {got_launches}")
    _add(launches, K)

    # 5. single-request latency, live and exported, after warm-up, and the
    # host and device time of one program call
    im = images[0]
    for name in FAMILIES:
        pm = click(im) if name == "prompt_model" else None
        row = {}
        for label, e in (("live", eng), ("exported", aot)):
            lat = []
            for _ in range(24):
                t = time.perf_counter()
                e.segment(im, name, pm)
                lat.append((time.perf_counter() - t) * 1e3)
            lat = lat[4:]
            row[label] = (round(_pct(lat, 0.5), 3), round(_pct(lat, 0.9), 3))
        inputs, _ = stage_request(im, aot.models[name], pm, aot.fast_transfer)
        batch = [a[None] for a in inputs]
        dispatch = aot.models[name].dispatch
        enqueue = []
        for _ in range(10):
            t = time.perf_counter()
            _, ready = dispatch(*batch)
            enqueue.append((time.perf_counter() - t) * 1e3)
            ready.synchronize()
        device = sum(_device_profile(lambda: dispatch(*batch)[0], iters=5).values())
        note = (" (live: repeat clicks on one image, clip branch cached; exported: the whole "
                "prompt model each request)" if name == "prompt_model" else "")
        print(f"[ckpt] {name} segment() 375x500, p50 / p90 ms over 20 requests after 4 "
              f"warm-up: live {row['live']}, exported {row['exported']}{note}; the program's "
              f"dispatch alone: host {statistics.median(enqueue):.3f} ms a call (median of "
              f"10), device {device:.3f} ms ({card})")


def _pet_files(root: str, n_train: int, n_val: int, seed: int) -> str:
    """A Pet-shaped file set under `root` in run.py's --data-root layout
    (Train/ and Val/, each color/<stem>.jpg + label/<stem>.png): sides drawn
    from 200-500 px, a trimap label {1 pet, 2 background, 3 boundary} of
    one ellipse, the image coloured by class with noise. Images are JPEG
    through PIL where it is installed, else PNG bytes through `encode_png`
    (under .jpg: the decoders read the signature). Returns which."""
    import os

    from image_segmentation_tpu_torch.data import png

    use_pil = png.pil_available()
    rng = np.random.default_rng(seed)
    colours = np.array([[0, 0, 0], [200, 120, 60], [60, 110, 170], [240, 240, 240]], np.float32)
    for split, n in (("Train", n_train), ("Val", n_val)):
        for sub in ("color", "label"):
            os.makedirs(os.path.join(root, split, sub))
        for i in range(n):
            h, w = (int(v) for v in rng.integers(200, 501, 2))
            yy, xx = np.ogrid[:h, :w]
            cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
            ry, rx = rng.uniform(0.15, 0.35) * h, rng.uniform(0.15, 0.35) * w
            r = np.sqrt(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2)
            lab = np.where(np.abs(r - 1) < 0.06, 3, np.where(r < 1, 1, 2)).astype(np.uint8)
            img = colours[lab] + rng.normal(0, 25, (h, w, 3)).astype(np.float32)
            img = np.clip(img, 0, 255).astype(np.uint8)
            color = os.path.join(root, split, "color", f"pet{i:04d}.jpg")
            if use_pil:
                from PIL import Image

                Image.fromarray(img).save(color, quality=90)
            else:
                with open(color, "wb") as f:
                    f.write(png.encode_png(img))
            with open(os.path.join(root, split, "label", f"pet{i:04d}.png"), "wb") as f:
                f.write(png.encode_png(lab))
    return "JPEG through PIL" if use_pil else "PNG through encode_png (no PIL)"


def _interleaved_step_report(steps: dict, batch: int, rounds: int = 8,
                             per_round: int = 4) -> dict:
    """Each named train step (each fed by its own set) after 3 warm-up
    steps, timed in alternating rounds of `per_round` steps, the order
    reversed every other round (CUDA events on the compute stream around
    each round; the host's enqueue time of each step on perf_counter):
    the median of the rounds' ms a step, and the median host ms a step.
    Then, from 2 steps each under torch.profiler, the device's kernel ms
    and host-to-device copy ms a step; idle = the share of the step in
    which no kernel runs."""
    for step in steps.values():
        for _ in range(3):
            step()
    torch.cuda.synchronize()
    names = list(steps)
    dev, host = {n: [] for n in names}, {n: [] for n in names}
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_round):
                t0 = time.perf_counter()
                steps[name]()
                host[name].append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            dev[name].append(start.elapsed_time(end) / per_round)
    out = {}
    for name in names:
        ms = statistics.median(dev[name])
        rows = _profile_session(steps[name], 2)
        copy = sum(t for k, (_, t) in rows.items() if "Memcpy" in k and "HtoD" in k) / 2e3
        kernels = sum(t for k, (_, t) in rows.items()
                      if "Memcpy" not in k and "Memset" not in k) / 2e3
        out[name] = {"ms": round(ms, 3), "rounds ms": [round(x, 1) for x in dev[name]],
                     "host ms": round(statistics.median(host[name]), 3),
                     "images/s": round(batch / ms * 1e3, 1), "kernel ms": round(kernels, 3),
                     "HtoD copy ms": round(copy, 3), "idle": round(1 - kernels / ms, 4)}
    return out


class _InlineExecutor:
    """A stand-in for `stream_rows`' worker pool that runs each gather at
    once on the caller's thread: the streamed step with the gather in
    series with the step's host enqueue, for comparison."""

    def __init__(self, **_):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        from concurrent.futures import Future

        f = Future()
        f.set_result(fn(*args))
        return f


def phase_host_data(K, launches: dict, card: str, tmp: str) -> None:
    """The host data path on the card's machine: both host libraries built
    from the port's sources, a Pet-shaped file set materialised natively
    and item by item, `unet_noaug` at full width through run.py on
    --data-root streamed past tiny device budgets against the same fit
    resident, and the two train-set paths' steps."""
    import contextlib
    import io
    import os

    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch import run as R
    from image_segmentation_tpu_torch.data import dataset as DS
    from image_segmentation_tpu_torch.data import loader as L
    from image_segmentation_tpu_torch.data import native_pipeline as NP
    from image_segmentation_tpu_torch.data import png
    from image_segmentation_tpu_torch.data.labels import target_remap
    from image_segmentation_tpu_torch.metrics import MetricsHistory
    from image_segmentation_tpu_torch.ops import _host_build as HB
    from image_segmentation_tpu_torch.ops import geometry as G
    from image_segmentation_tpu_torch.ops import native
    from image_segmentation_tpu_torch.ops import native_codec as nc
    from image_segmentation_tpu_torch.train import loop
    from image_segmentation_tpu_torch.train.fast_eval import plan_size_buckets
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import (
        ResidentTrainSet,
        StreamedTrainSet,
        resident_plan,
        train_step,
    )

    # 1. the host libraries, built now from native/*.cpp into build/torch_native/
    secs = native.LIBRARY.build()
    assert native.available()
    print(f"[host] resampler built in {secs:.2f} s: {native.LIBRARY.path} ({card})")
    why = HB.missing_prerequisites(nc.LIBRARY.headers)
    if why is None:
        secs = nc.LIBRARY.build()
        assert nc.available()
        print(f"[host] codec built in {secs:.2f} s against libpng {_header_version('png.h')} "
              f"and libjpeg {_header_version('jpeglib.h')}: {nc.LIBRARY.path}")
    else:
        print(f"[host] FINDING: the native codec cannot build on this machine ({why}); the "
              f"rest of the phase runs on the fallback decoders (PIL: "
              f"{png.pil_available()}, else the port's PNG codec)")
    codec = why is None

    # 2. a Pet-shaped file set, materialised natively and item by item
    n_train, n_val, side = 256, 64, 256
    root = os.path.join(tmp, "pet")
    t0 = time.time()
    how = _pet_files(root, n_train, n_val, seed=11)
    print(f"[host] wrote {n_train} train + {n_val} val Pet-shaped images (sides 200-500 px, "
          f"trimaps {{1, 2, 3}}) as {how} in {time.time() - t0:.1f} s")
    sets = {split: DS.SegmentationDataset(os.path.join(root, split, "color"),
                                          os.path.join(root, split, "label"),
                                          target_transform=target_remap)
            for split in ("Train", "Val")}
    workers = NP.default_workers()
    out = {}
    for split, ds in sets.items():
        keep = split == "Val"
        if codec:
            t0 = time.perf_counter()
            fast = NP.try_materialize_dataset(ds, side, keep_orig_labels=keep, workers=workers)
            t_fast = time.perf_counter() - t0
        t0 = time.perf_counter()
        slow = L.materialize(ds, side, keep_orig_labels=keep, native=False)
        t_slow = time.perf_counter() - t0
        out[split] = fast if codec else slow
        line = (f"[host] {split}: {len(ds)} items, item by item (PIL or PNG decode, C++ "
                f"resampler) {len(ds) / t_slow:.1f} images/s")
        if codec:
            err = float(np.abs(fast.images - slow.images).max())
            same = (np.array_equal(fast.labels, slow.labels)
                    and all(np.array_equal(np.asarray(a), np.asarray(b))
                            for a, b in zip(fast.metas, slow.metas))
                    and all(np.array_equal(a, b) for a, b in zip(fast.orig_labels or [],
                                                                  slow.orig_labels or [])))
            line += (f"; native {len(ds) / t_fast:.1f} images/s with {workers} workers of "
                     f"os.cpu_count() {os.cpu_count()}; images max |native - item| {err:.2e} "
                     f"(tolerance 2e-2: two JPEG decoders), labels, metas and originals equal "
                     f"{same}")
            if err > 2e-2 or not same:
                raise AssertionError(f"native materialisation disagrees: {err}, {same}")
        print(line + f" ({card})")
    val_ds = sets["Val"]
    sub = DS.SegmentationDataset(val_ds.img_dir, val_ds.label_dir,
                                 target_transform=target_remap)
    sub.stems = sub.stems[:32]
    saved = G._native
    G._native = lambda: None  # the numpy resampler, for its rate alone
    try:
        t0 = time.perf_counter()
        L.materialize(sub, side, keep_orig_labels=True, native=False)
        t_np = time.perf_counter() - t0
    finally:
        G._native = saved
    print(f"[host] 32 val items, PIL/PNG decode + numpy resampler: {32 / t_np:.1f} images/s "
          f"(one thread; os.cpu_count() {os.cpu_count()})")

    # 3. unet_noaug at full width on --data-root: streamed, then resident
    cfg = C.UNET_NOAUG
    train, val = out["Train"], out["Val"]
    train_bytes = train.images.nbytes + train.labels.nbytes
    plan = resident_plan(train_bytes, 16 << 20)
    labels = val.orig_labels
    batches = sum(-(-len(b) // cfg.batch_size) for b in plan_size_buckets(labels))
    want = (0, 0, 9 * batches * 2)
    argv = ["--config", "unet_noaug", "--data-root", root, "--epochs", "2", "--device", "cuda"]
    env = {loop.BUDGET_ENV: "16", loop.EVAL_BUDGET_ENV: "1"}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for name, budgets in (("streamed", env), ("resident", {})):
            old = {k: os.environ.pop(k, None) for k in env}
            os.environ.update(budgets)
            log = io.StringIO()
            try:
                _zero(K)
                t0 = time.time()
                with _FirstLoss() as spy, contextlib.redirect_stdout(log):
                    res = R.main(argv + ["--save-dir", os.path.join(tmp, name)])
                wall = time.time() - t0
                counts = _counts(K)
                _add(launches, K)
            finally:
                for k, v in old.items():
                    os.environ.pop(k, None)
                    if v is not None:
                        os.environ[k] = v
            streamed_lines = [l for l in log.getvalue().splitlines()
                              if "[fit] streaming" in l or "val: streaming" in l]
            steps = [float(x) for x in spy.losses]
            runs[name] = (res, steps, counts, streamed_lines)
            print(f"[host] run.py unet_noaug --data-root, {name} ({budgets or 'budgets unset'}): "
                  f"{wall:.1f} s; step losses {[round(x, 6) for x in steps]}; val mIoU "
                  f"{res.history['val_iou']}; launches {counts}, want {want} = 9 per eval batch "
                  f"x {batches} x 2 epochs; streaming notes {len(streamed_lines)} "
                  f"({streamed_lines[:2]})")
            if counts != want:
                raise AssertionError(f"{name} fit launches {counts}, want {want}")
            if not all(np.isfinite(steps)) or len(steps) != 2 * (n_train // 64):
                raise AssertionError(f"{name} step losses {steps}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (res_s, steps_s, _, notes_s), (res_r, steps_r, _, notes_r) = runs["streamed"], runs["resident"]
    both = all(any(tag in l for l in notes_s) for tag in ("[fit] streaming", "val: streaming"))
    if plan != "stream" or not both or notes_r:
        raise AssertionError(f"the streamed run's train and eval did not both stream ({plan}, "
                             f"{notes_s}) or the resident one streamed ({notes_r})")
    rel = max(abs(a - b) / abs(b) for a, b in zip(steps_s, steps_r))
    same_params = all(torch.equal(a, b) for a, b in zip(res_s.state.model.state_dict().values(),
                                                        res_r.state.model.state_dict().values()))
    print(f"[host] streamed vs resident: step losses max relative difference {rel:.3e} "
          f"(tolerance 1e-3), final parameters bit-equal {same_params}, val histories equal "
          f"{res_s.history['val_iou'] == res_r.history['val_iou']}")
    if rel > 1e-3:
        raise AssertionError(f"streamed and resident losses differ by {rel}")

    # the eval: per batch (1 MB budget) against resident, on each final state
    def evaluate(state, budget):
        old = os.environ.pop(loop.EVAL_BUDGET_ENV, None)
        if budget is not None:
            os.environ[loop.EVAL_BUDGET_ENV] = budget
        try:
            agg = MetricsHistory(cfg.num_classes, ignore_index=cfg.eval_ignore_index)
            _zero(K)
            res = loop.evaluate(state, val, loss_cfg=C.build_val_loss(cfg), agg=agg,
                                verbose=False)
            # per batch holds no val set on the card; resident holds each bucket's
            views = val.bucket_views or [val]
            if any((v.device_eval_cache is None) != (budget is not None) for v in views):
                raise AssertionError(f"eval at budget {budget!r} took the wrong path")
            return res, agg.confusion.copy(), _counts(K)[2]
        finally:
            os.environ.pop(loop.EVAL_BUDGET_ENV, None)
            if old is not None:
                os.environ[loop.EVAL_BUDGET_ENV] = old

    (e_s, c_s, k_s), (e_r, c_r, k_r) = evaluate(res_s.state, "1"), evaluate(res_s.state, None)
    print(f"[host] eval of the streamed run's state: per batch vs resident confusion equal "
          f"{np.array_equal(c_s, c_r)}, val loss {e_s['loss']:.6f} / {e_r['loss']:.6f}, K1 "
          f"{k_s} / {k_r} launches (not counted in the kernels line)")
    if (not np.array_equal(c_s, c_r) or e_s["loss"] != e_r["loss"]
            or (k_s, k_r) != (9 * batches, 9 * batches)):
        raise AssertionError("per-batch eval differs from the resident eval")
    _, c_rr, _ = evaluate(res_r.state, None)
    agree = 1 - np.abs(c_s - c_rr).sum() / 2 / c_s.sum()
    print(f"[host] eval confusions of the two runs' states: equal {np.array_equal(c_s, c_rr)}, "
          f"pixel agreement {agree:.6f}")
    if same_params and not np.array_equal(c_s, c_rr):
        raise AssertionError("equal states, unequal confusions")
    if not same_params:
        print("[host] the two runs' parameters differ under cudnn.deterministic: the card's "
              "kernels are not deterministic here (atomics in a backward); held to pixel "
              "agreement >= 0.999 instead of equality")
        if agree < 0.999:
            raise AssertionError(f"pixel agreement {agree} < 0.999")

    # 4. the two train-set paths' steps at full width (batch 64 = 8 x 8)
    model = C.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    st = TrainState(model, *C.build_optimizer(cfg, model))
    loss_fn = C.build_loss(cfg)
    # one order of 10 epochs' steps per set, so no stream restarts inside the
    # 3 warm-up, 8 x 4 timed and 2 profiled steps
    order_rng = np.random.default_rng(0)
    order = np.concatenate([order_rng.permutation(n_train) for _ in range(10)]).reshape(-1, 64)
    from image_segmentation_tpu_torch.train import steps as steps_mod

    feeds = {"resident": ResidentTrainSet(train.images, train.labels, "cuda",
                                          False).batches(order),
             "streamed": StreamedTrainSet(train.images, train.labels, "cuda").batches(order),
             "streamed, gather on the step's thread":
                 StreamedTrainSet(train.images, train.labels, "cuda").batches(order)}
    first = {}
    pool = steps_mod.ThreadPoolExecutor
    steps_mod.ThreadPoolExecutor = _InlineExecutor  # taken when the feed starts
    try:
        first["streamed, gather on the step's thread"] = next(
            feeds["streamed, gather on the step's thread"])
    finally:
        steps_mod.ThreadPoolExecutor = pool

    def step_of(name):
        def step():
            b = first.pop(name, None) or next(feeds[name])
            train_step(st, loss_fn, *b, cfg.accum_steps)
        return step

    reports = _interleaved_step_report({name: step_of(name) for name in feeds}, 64)
    for feed in feeds.values():
        feed.close()
    del feeds
    for name, rep in reports.items():
        print(f"[host] train step, UNet base 64, 256 px, batch 64 (8 x 8), {name}: {rep} "
              f"({card})")
    gap = reports["streamed"]["ms"] / reports["resident"]["ms"] - 1
    print(f"[host] streamed step against resident, rounds interleaved: {gap:+.2%}; idle "
          f"{reports['streamed']['idle']:.2%} against {reports['resident']['idle']:.2%}")
    pinned = [torch.from_numpy(a[:64]).pin_memory() for a in (train.images, train.labels)]
    nbytes = sum(t.numel() * t.element_size() for t in pinned)
    copy_ms = _cuda_ms(lambda: [t.to("cuda", non_blocking=True) for t in pinned], iters=10,
                       warmup=2)
    srcs = [torch.from_numpy(a) for a in (train.images, train.labels)]
    gather = []
    for i in range(10):
        idx = torch.from_numpy(order[i])
        t0 = time.perf_counter()
        for src, dst in zip(srcs, pinned):
            torch.index_select(src, 0, idx, out=dst)
        gather.append((time.perf_counter() - t0) * 1e3)
    gather_ms = statistics.median(gather)
    print(f"[host] one step batch's images and labels ({nbytes} bytes): host gather into pinned "
          f"memory {gather_ms:.3f} ms (perf_counter, median of 10; on the stream's worker "
          f"thread, beside the step), pinned host to device {copy_ms:.3f} ms (CUDA events, "
          f"median of 10), {nbytes / copy_ms / 1e6:.1f} GB/s; os.cpu_count() {os.cpu_count()} "
          f"({card})")


# ---- phase 15: data parallelism across processes ------------------------

DP_CHILD_TIMEOUT_S = 300
# the fit-history keys every process must hold alike (each keeps its own clock)
DP_HISTORY = ("train_loss", "val_loss", "val_dice", "val_iou", "val_acc", "val_per_class_iou")


def _dp_start(task: str, world: int, tmp: str, spec: dict) -> list:
    """Start `world` processes of this script (`--dp-child`) running `task`
    in one group on a file:// store under `tmp`."""
    import os

    store = f"file://{tmp}/store.{task}.{world}.{time.monotonic_ns()}"
    procs = []
    for r in range(world):
        out = os.path.join(tmp, f"{task}.{world}.{r}.{time.monotonic_ns()}.json")
        child = dict(spec, task=task, rank=r, world=world, store=store, out=out)
        log = open(out + ".log", "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-child",
                                        json.dumps(child)], stdout=log,
                                       stderr=subprocess.STDOUT, text=True), out, log))
    return procs


def _dp_wait(procs: list) -> list:
    """Each child's result and log, once all have exited 0 within
    DP_CHILD_TIMEOUT_S (a child past it is killed and fails the phase)."""
    deadline = time.monotonic() + DP_CHILD_TIMEOUT_S
    try:
        for p, _, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, _, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    results = []
    for r, (p, out, _) in enumerate(procs):
        with open(out + ".log") as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError(f"data-parallel child {r} exited {p.returncode}:\n"
                                 f"{text[-4000:]}")
        with open(out) as f:
            results.append(dict(json.load(f), log=text))
    return results


def _dp_child_step(spec: dict) -> dict:
    """(a), one rank: the full-width step on this rank's rows, from the
    shared init and batch; its state after step 1; two more steps timed."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.parallel.mesh import get_mesh
    from image_segmentation_tpu_torch.parallel.multihost import initialize_multihost
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import local_step_rows, train_step

    backend = initialize_multihost(spec["store"], spec["world"], spec["rank"], "cuda")
    axis = get_mesh("cuda")
    cfg = C.UNET_NOAUG
    shared = torch.load(spec["inputs"])
    model = C.build_model(cfg, axis.device, torch.Generator().manual_seed(0))
    model.load_state_dict(shared["init"])
    st = TrainState(model, *C.build_optimizer(cfg, model))
    rows = torch.from_numpy(local_step_rows(len(shared["x"]), cfg.accum_steps, axis))
    x, y = shared["x"][rows].to(axis.device), shared["y"][rows].to(axis.device)
    loss_fn = C.build_loss(cfg)
    loss = float(train_step(st, loss_fn, x, y, cfg.accum_steps))
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, spec["out"] + ".pt")
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        train_step(st, loss_fn, x, y, cfg.accum_steps)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    import torch.distributed as dist

    # what the step's collectives cost on their own: the one flat gradient
    # all-reduce, and a BN-sized one (its f64 channel sums), 50 times
    flat = torch.zeros(sum(p.numel() for p in model.parameters()), device=axis.device)
    small = torch.zeros(65, dtype=torch.float64, device=axis.device)
    coll_ms = {}
    for name, t, n in (("gradients", flat, 3), ("bn_sums", small, 50)):
        dist.all_reduce(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        coll_ms[name] = (time.perf_counter() - t0) * 1e3 / n
    dist.destroy_process_group()
    return {"loss": loss, "ms": ms, "backend": backend, "collective_ms": coll_ms,
            "grad_bytes": flat.numel() * 4}


def _dp_child_run(spec: dict, K) -> dict:
    """(b), (c), one rank: `run.main --multihost` with the counts zeroed just
    before and read just after; the files it wrote and the confusions it
    accumulated."""
    from image_segmentation_tpu_torch import run as R
    from image_segmentation_tpu_torch.metrics import MetricsHistory
    from image_segmentation_tpu_torch.train import checkpoint as ckpt
    from image_segmentation_tpu_torch.train import loop

    writes, confusions = [], []
    write, params_only, history = ckpt._write, ckpt.save_params_only, loop._save_history
    accumulate = MetricsHistory.accumulate_confusion
    ckpt._write = lambda path, *a: (writes.append(path), write(path, *a))
    ckpt.save_params_only = lambda path, *a: (writes.append(path), params_only(path, *a))
    loop._save_history = lambda d, n, h: (writes.append("history"), history(d, n, h))

    def record(self, conf):
        confusions.append(torch.as_tensor(conf).cpu().tolist())
        return accumulate(self, conf)

    MetricsHistory.accumulate_confusion = record
    argv = spec["argv"] + ["--multihost", "--coordinator", spec["store"], "--num-processes",
                           str(spec["world"]), "--process-id", str(spec["rank"])]
    _zero(K)
    t0 = time.time()
    res = R.main(argv)
    counts = _counts(K)
    return {"counts": counts, "seconds": time.time() - t0, "writes": writes,
            "confusions": confusions,
            "history": {k: np.asarray(res.history[k]).tolist() for k in DP_HISTORY}}


def dp_child(spec: dict) -> int:
    """A child process of phases 15 and 16 (`python3 chip_smoke.py --dp-child
    SPEC`)."""
    from image_segmentation_tpu_torch.ops.kernels import _build
    from image_segmentation_tpu_torch.ops.kernels import attention as A
    from image_segmentation_tpu_torch.ops.kernels import double_conv as D
    from image_segmentation_tpu_torch.ops.kernels import mlp as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    tasks = {"step": lambda: _dp_child_step(spec), "run": lambda: _dp_child_run(spec, (A, M, D)),
             "mp": lambda: _dp_child_mp(spec, (A, M, D))}
    result = tasks[spec["task"]]()
    with open(spec["out"], "w") as f:
        json.dump(result, f)
    return 0


def _backend_line(log: str) -> str:
    return next(l for l in log.splitlines() if l.startswith("[run] multihost:"))


def _update(before: dict, after: dict) -> torch.Tensor:
    """The step's change of every parameter but the BN-fed conv biases, flat."""
    return torch.cat([(after[k].double() - before[k].double()).flatten() for k in before
                      if "running" not in k and not k.endswith(BN_FED_BIAS)
                      and after[k].is_floating_point()])


def unet_step_refs() -> dict:
    """One process's full-width unet_noaug step (UNet base 64, 256 px, batch
    64 = micro 8 x accum 8) from BN-perturbed seeded weights, in f32 and in
    bf16, and the bf16 state's next two steps' ms: what phases 15 and 16
    hold their ranks' steps against."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import train_step

    cfg = C.UNET_NOAUG
    model = C.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    _perturb_batchnorm_(model, 2)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    x, y = _full_batch(cfg.batch_size * cfg.accum_steps, seed=3)
    loss_fn = C.build_loss(cfg)
    after, losses = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        m = C.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
        m.load_state_dict(init)
        m.dtype = dtype
        st = TrainState(m, *C.build_optimizer(cfg, m))
        losses[dtype] = float(train_step(st, loss_fn, x, y, cfg.accum_steps))
        after[dtype] = {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
    one_ms = []
    for _ in range(2):  # the bf16 state's next steps, timed as the children time theirs
        torch.cuda.synchronize()
        t = time.perf_counter()
        train_step(st, loss_fn, x, y, cfg.accum_steps)
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t) * 1e3)
    return {"init": init, "x": x.cpu(), "y": y.cpu(), "after": after, "losses": losses,
            "one_ms": one_ms}


def phase_data_parallel(K, launches: dict, card: str, tmp: str) -> dict:
    """Data parallelism across processes on the one card (module docstring,
    phase 15): (a) one full-width step in 2 ranks sharing the card against
    the single-process step; (b) `run.py --multihost unet_noaug` in 2
    ranks; (c) `clipunet` in line under `--multihost`, 1 rank over NCCL,
    then 2 ranks over gloo."""
    import os

    from image_segmentation_tpu_torch import config as C

    # (a) one step: UNet base 64, 256 px, batch 64 = micro 8 x accum 8, bf16
    cfg = C.UNET_NOAUG
    refs = unet_step_refs()
    init, x, y, after, losses, one_ms = (refs[k] for k in ("init", "x", "y", "after", "losses",
                                                           "one_ms"))
    # the ranks start once this process is done with the card
    inputs = os.path.join(tmp, "dp_inputs.pt")
    torch.save({"init": init, "x": x.cpu(), "y": y.cpu()}, inputs)
    procs = _dp_start("step", 2, tmp, {"inputs": inputs})
    res = _dp_wait(procs)
    dp = [torch.load(p[1] + ".pt") for p in procs]
    if not all(torch.equal(dp[0][k], dp[1][k]) for k in dp[0]):
        raise AssertionError("the two ranks' states differ after the step")
    bf16, f32 = after[torch.bfloat16], after[torch.float32]
    d_dp, d_bf16, d_f32 = (_update(init, s) for s in (dp[0], bf16, f32))
    cos_dp, cos_own = _cosine(d_dp, d_bf16), _cosine(d_bf16, d_f32)
    cos_params = _cosine(torch.cat([dp[0][k].double().flatten() for k in init
                                    if dp[0][k].is_floating_point()]),
                         torch.cat([bf16[k].double().flatten() for k in init
                                    if bf16[k].is_floating_point()]))
    loss_rel = abs(res[0]["loss"] - losses[torch.bfloat16]) / abs(losses[torch.bfloat16])
    own_rel = abs(losses[torch.bfloat16] - losses[torch.float32]) / abs(losses[torch.float32])
    stat_err = max(float((dp[0][k] - v).abs().max() / max(1.0, float(v.abs().max())))
                   for k, v in bf16.items() if "running" in k)
    print(f"[dp] (a) one step, UNet base 64, 256 px, batch 64 (micro 8 x accum 8), bf16, 2 "
          f"ranks sharing the card ({res[0]['backend']}) against one process: loss "
          f"{res[0]['loss']:.6f} / {res[1]['loss']:.6f} vs {losses[torch.bfloat16]:.6f} (rel "
          f"{loss_rel:.2e}; the single step's bf16 vs f32: {own_rel:.2e}); parameters' cosine "
          f"after the step {cos_params:.9f}; the step's update cosine {cos_dp:.6f} (bf16 vs f32 "
          f"in one process: {cos_own:.6f}); running statistics max scaled diff {stat_err:.3e}")
    print(f"[dp] (a) step ms (perf_counter around a synchronised step, steps 2 and 3): one "
          f"process {[round(t, 3) for t in one_ms]}, 2 ranks sharing the card "
          f"{[[round(t, 3) for t in r['ms']] for r in res]} ({card}); two ranks on one card "
          f"time the code path, not scaling")
    print(f"[dp] (a) one gloo all-reduce of CUDA tensors between the 2 ranks: the flat "
          f"gradients ({res[0]['grad_bytes']} bytes) {res[0]['collective_ms']['gradients']:.3f} "
          f"ms, a BN layer's f64 sums (65 values) {res[0]['collective_ms']['bn_sums']:.3f} ms; "
          f"a step makes 1 of the first and 18 x 2 x 2 x 8 = 576 of the second (18 BN layers, "
          f"2 sums each, forward and backward, 8 micro-batches) ({card})")
    # bounds from the step's own bf16 error, as phase 8 states them: the loss
    # within BF16_LOSS_RTOL, the statistics within BF16_STAT_TOL, and the
    # update no farther from the single bf16 step's than the single bf16
    # step's is from f32's (1 - cosine), times BF16_GRAD_RATIO
    if not (loss_rel <= BF16_LOSS_RTOL and stat_err <= BF16_STAT_TOL
            and 1 - cos_dp <= BF16_GRAD_RATIO * (1 - cos_own)
            and res[0]["loss"] == res[1]["loss"]):
        raise AssertionError(f"the 2-rank step disagrees with one process's beyond bf16's own "
                             f"reach: loss {loss_rel}, stats {stat_err}, update cosine "
                             f"{cos_dp} vs {cos_own}")

    # (b) run.py --multihost unet_noaug, 2 ranks, 2 epochs, and (c) clipunet in
    # line under --multihost in a world of one over NCCL, side by side
    n_train = 64
    n_val = n_train // 4
    per_rank = 9 * _eval_batches(n_val, cfg.seed + 1, cfg.batch_size) * 2
    unet = _dp_start("run", 2, tmp, {"argv": [
        "--config", "unet_noaug", "--synthetic", str(n_train), "--epochs", "2", "--save-dir",
        os.path.join(tmp, "dp_unet"), "--device", "cuda"]})
    clip_argv = ["--config", "clipunet", "--synthetic", "16", "--epochs", "1", "--device", "cuda"]
    nccl = _dp_start("run", 1, tmp, {"argv": clip_argv + ["--save-dir",
                                                           os.path.join(tmp, "dp_clip1")]})
    res, (one,) = _dp_wait(unet), _dp_wait(nccl)
    for r, rr in enumerate(res):
        print(f"[dp] (b) rank {r}: {_backend_line(rr['log'])}; {rr['seconds']:.1f} s; "
              f"launches {rr['counts']}, want (0, 0, {per_rank}); train loss "
              f"{rr['history']['train_loss']}, val mIoU {rr['history']['val_iou']}; files "
              f"written {len(rr['writes'])} ({card})")
        _add_counts(launches, rr["counts"])
    same = all(res[1]["history"][k] == res[0]["history"][k] for k in DP_HISTORY)
    if (any(tuple(r["counts"]) != (0, 0, per_rank) for r in res) or not same
            or res[0]["confusions"] != res[1]["confusions"] or len(res[0]["confusions"]) != 2
            or res[1]["writes"] or "history" not in res[0]["writes"]
            or "gloo" not in _backend_line(res[0]["log"])
            or any(f"Epoch {e}/2" in res[1]["log"] for e in (1, 2))
            or not all(os.path.isdir(os.path.join(tmp, "dp_unet", d))
                       for d in ("unet_noaug", "unet_noaug_last", "MO_unet_noaug"))):
        raise AssertionError("the 2-rank unet_noaug run: launches, histories, confusions, "
                             "writes or files are not as they should be")
    # clipunet: 16 train (micro 8 x accum 2, one step an epoch) and 4 val
    # images; each rank forwards the ViT once per micro-batch and once per
    # eval batch, 12 K3 and 12 K4 launches each time
    n_vit = 12 * (2 + _eval_batches(4, C.CLIPUNET.seed + 1, 8))
    print(f"[dp] (c) clipunet in line, 1 rank: {_backend_line(one['log'])}; "
          f"{one['seconds']:.1f} s; launches {one['counts']}, want ({n_vit}, {n_vit}, 0); train "
          f"loss {one['history']['train_loss']} ({card})")
    _add_counts(launches, one["counts"])
    if tuple(one["counts"]) != (n_vit, n_vit, 0) or "nccl" not in _backend_line(one["log"]):
        raise AssertionError(f"clipunet in one NCCL rank: {one['counts']}")
    two = _dp_wait(_dp_start("run", 2, tmp, {"argv": clip_argv + [
        "--save-dir", os.path.join(tmp, "dp_clip2")]}))
    for r, rr in enumerate(two):
        print(f"[dp] (c) clipunet in line, rank {r} of 2: {_backend_line(rr['log'])}; "
              f"{rr['seconds']:.1f} s; launches {rr['counts']}; train loss "
              f"{rr['history']['train_loss']}")
        _add_counts(launches, rr["counts"])
    rel = abs(two[0]["history"]["train_loss"][0] - one["history"]["train_loss"][0]) / abs(
        one["history"]["train_loss"][0])
    if (any(tuple(r["counts"]) != (n_vit, n_vit, 0) for r in two)
            or two[0]["history"] != two[1]["history"] or rel > BF16_LOSS_RTOL):
        raise AssertionError(f"clipunet in 2 gloo ranks: launches "
                             f"{[r['counts'] for r in two]}, loss rel {rel} to one rank")
    return refs


# ---- phase 16: model parallelism and mesh serving -----------------------

# ViT-B/16's 12 blocks in 2 stages of 6, 4 micro-batches of a batch of 8
PP_STAGES, PP_MICRO = 2, 4
HOST_COLLECTIVES = "every collective goes through the host: the code path, not scaling"


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _own_bound(got, one, f32) -> tuple:
    """(error, bound): `got`'s relative L2 from the f32 forward, and 1.5x
    the one-process bf16 forward's (the forward's own bf16 error)."""
    return _rel_l2(got, f32), 1.5 * _rel_l2(one, f32)


def _mp_counts(K) -> tuple:
    """(K3, K4, K1, K4's TP entry) launches since the last `_mp_zero`."""
    return _counts(K) + (K[1].PARTIAL_LAUNCHES,)


def _mp_zero(K) -> None:
    _zero(K)
    K[1].PARTIAL_LAUNCHES = 0


def _timed_ms(fn, iters: int = 3) -> list:
    """perf_counter ms of synchronised calls of fn (after one warm call)."""
    fn()
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


@contextlib.contextmanager
def _recording_k1_shapes():
    """Within: the shape of every call of K1 and its concat entry from the
    UNet's K1 forward, as phase 3's K1_CASES ([N, H, W, Cin], Cout) and
    K1_CAT_CASES ([N, H, W], Cskip, Cup, Cout) name them."""
    from image_segmentation_tpu_torch.models import fused_unet as FU
    from image_segmentation_tpu_torch.ops.kernels import blocks as KB

    shapes = []

    def recorded(fn, cat):
        def run(*a):
            cout = a[-3].shape[-1]  # w2, HWIO
            shapes.append([list(a[0].shape[:3]), a[0].shape[3], a[1].shape[3], cout] if cat
                          else [list(a[0].shape), cout])
            return fn(*a)
        return run

    k1, cat = KB.fused_double_conv, KB.fused_double_conv_cat
    KB.fused_double_conv = FU.fused_double_conv = recorded(k1, False)
    KB.fused_double_conv_cat = recorded(cat, True)
    try:
        yield shapes
    finally:
        KB.fused_double_conv = FU.fused_double_conv = k1
        KB.fused_double_conv_cat = cat


def _unchecked_slabs(slabs: list) -> list:
    """The recorded K1 shapes that phase 3 did not hold against the plain
    version."""
    k1 = {(tuple(x), c) for x, c, _ in K1_CASES}
    cat = {(nhw, cs, cu, c) for nhw, cs, cu, c in K1_CAT_CASES}
    return [sh for sh in slabs if ((tuple(sh[0]), sh[1]) not in k1 if len(sh) == 2
                                   else (tuple(sh[0]), *sh[1:]) not in cat)]


def _dp_child_mp(spec: dict, K) -> dict:
    """Phase 16, one of 2 ranks sharing the card over gloo: (a) TP over the
    ViT (dp1 x tp2), (b) the GPipe pipeline (2 stages), (c) SP of the
    UNet (2 shards of H); the counts zeroed just before each path and read
    just after; outputs saved beside the result."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.models.clip_vit import (
        ClipViT,
        ClipViTConfig,
        TransformerBlock,
    )
    from image_segmentation_tpu_torch.parallel import pp, sp, tp
    from image_segmentation_tpu_torch.parallel.mesh import get_mesh
    from image_segmentation_tpu_torch.parallel.multihost import initialize_multihost
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import train_step

    backend = initialize_multihost(spec["store"], spec["world"], spec["rank"], "cuda")
    mesh = get_mesh("cuda", model_parallel=2)
    shared = torch.load(spec["inputs"])
    dev = mesh.device
    res, saved = {"backend": backend}, {}

    # (a) TP: the full-width ClipUNet forward, then one in-line train step
    cfg = C.CLIPUNET
    model = C.build_model(cfg, dev, torch.Generator().manual_seed(0))
    model.load_state_dict(shared["clip"])
    tp.shard_params_tp(model, mesh)
    x = shared["clip_x"].to(dev)
    _mp_zero(K)
    with torch.inference_mode():
        saved["tp"] = model(x).cpu()
    torch.cuda.synchronize()
    res["tp_counts"] = _mp_counts(K)
    with torch.inference_mode():
        res["tp_ms"] = _timed_ms(lambda: model(x))
    del model
    model = C.build_model(cfg, dev, torch.Generator().manual_seed(0))
    model.load_state_dict(shared["clip"])
    tp.shard_params_tp(model, mesh)
    st = TrainState(model, *C.build_optimizer(cfg, model))
    xs, ys = shared["clip_step_x"].to(dev), shared["clip_step_y"].to(dev)
    _mp_zero(K)
    res["tp_step_loss"] = float(train_step(st, C.build_loss(cfg), xs, ys, cfg.accum_steps))
    torch.cuda.synchronize()
    res["tp_step_counts"] = _mp_counts(K)
    res["tp_step_ms"] = _timed_ms(lambda: train_step(st, C.build_loss(cfg), xs, ys,
                                                     cfg.accum_steps), iters=1)
    del model, st

    # (b) PP: ViT-B/16's blocks in 2 stages of 6, M = 4, forward only
    vcfg = ClipViTConfig()
    vit_state = {k[len("vision_model."):]: v.to(dev) for k, v in shared["clip"].items()
                 if k.startswith("vision_model.encoder.")}
    local = pp.shard_stacked_params(pp.stack_block_params(vit_state, vcfg.num_layers), mesh)
    block_fn = pp.block_fn_for(TransformerBlock(vcfg, use_kernels=True).to(dev))
    x0 = shared["pp_x0"].to(dev)
    _mp_zero(K)
    with torch.inference_mode():
        final, per_layer = pp.pipeline_blocks(block_fn, local, x0, mesh, PP_MICRO)
    torch.cuda.synchronize()
    res["pp_counts"] = _mp_counts(K)
    saved["pp_final"], saved["pp_layers"] = final.cpu(), per_layer.cpu()
    with torch.inference_mode():
        res["pp_ms"] = _timed_ms(lambda: pp.pipeline_blocks(block_fn, local, x0, mesh,
                                                            PP_MICRO))
    del local, final, per_layer

    # (c) SP: the UNet-64 at 256 px in 2 shards of 128 rows (H on the data
    # axis of the world, every rank the whole batch)
    ucfg = C.UNET_NOAUG
    mesh_sp = get_mesh("cuda")
    unet = C.build_model(ucfg, dev, torch.Generator().manual_seed(0))
    unet.load_state_dict(shared["unet"])
    sp.partition_model(unet, mesh_sp)
    ux = sp.shard_batch_spatial(shared["unet_x"].to(dev), mesh_sp)
    _mp_zero(K)
    with torch.inference_mode(), _recording_k1_shapes() as slabs:
        saved["sp"] = unet(ux).cpu()
    torch.cuda.synchronize()
    res["sp_counts"], res["sp_slabs"] = _mp_counts(K), slabs
    with torch.inference_mode():
        res["sp_ms"] = _timed_ms(lambda: unet(ux))
    unet = C.build_model(ucfg, dev, torch.Generator().manual_seed(0))
    unet.load_state_dict(shared["unet_step_init"])
    sp.partition_model(unet, mesh_sp)
    st = TrainState(unet, *C.build_optimizer(ucfg, unet))
    sx, sy = sp.shard_batch_spatial((shared["unet_step_x"].to(dev),
                                     shared["unet_step_y"].to(dev)), mesh_sp)
    res["sp_step_loss"] = float(train_step(st, C.build_loss(ucfg), sx, sy, ucfg.accum_steps))
    saved["sp_state"] = {k: v.detach().cpu().clone() for k, v in unet.state_dict().items()}
    res["sp_step_ms"] = _timed_ms(lambda: train_step(st, C.build_loss(ucfg), sx, sy,
                                                     ucfg.accum_steps), iters=1)
    torch.save(saved, spec["out"] + ".pt")
    import torch.distributed as dist

    dist.destroy_process_group()
    return res


def _staged_batch(entry, n: int, seed: int) -> list:
    """n staged requests of a family, as uint8 (fast_transfer)."""
    rng = np.random.default_rng(seed)
    t = entry.target_size
    xs = [rng.integers(0, 256, (n, t, t, 3), dtype=np.uint8)]
    if entry.needs_prompt:
        heat = np.zeros((n, t, t, 1), np.uint8)
        heat[:, t // 3:t // 2, t // 3:t // 2] = 255
        xs.append(heat)
    return xs


def phase_mesh_serving(K, launches: dict, card: str, devices=("cuda:0", "cuda:0")) -> None:
    """(d): the four full-width families on InferenceEngine(devices=[cuda:0,
    cuda:0]) against the one-device engine, on batches of 4 (--max-batch
    4): each runs as one chunk a device, a replica on each; the scores
    equal the one-device engine's chunk by chunk, and the launches are
    those of the chunks."""
    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.serve.engine import InferenceEngine

    specs = (("unet", C.UNET_NOAUG, 256, False), ("autoencoder", C.AUTOENCODER, 256, False),
             ("clip", C.CLIPUNET, 224, False), ("prompt_model", C.PROMPT, 224, True))
    one = InferenceEngine("cuda")
    meshed = InferenceEngine(devices=list(devices))
    n = len(devices)
    for i, (name, cfg, t, prompt) in enumerate(specs):
        model = C.build_model(cfg, "cuda", torch.Generator().manual_seed(20 + i))
        _perturb_batchnorm_(model, 30 + i)
        one.register(name, model, t, needs_prompt=prompt)
        meshed.register(name, model, t, needs_prompt=prompt)
    for name, *_ in specs:
        xs = _staged_batch(meshed.models[name], 4, 7)
        one.forward(name, *xs)  # warm both engines: each replica's first call
        meshed.forward(name, *xs)
        _mp_zero(K)
        want = np.concatenate([one.forward(name, *(np.array_split(x, n)[i] for x in xs))
                               for i in range(n)])
        chunk = _mp_counts(K)
        _mp_zero(K)
        t0 = time.perf_counter()
        got = meshed.forward(name, *xs)
        ms = (time.perf_counter() - t0) * 1e3
        counts = _mp_counts(K)
        _add_counts(launches, counts)
        whole = one.forward(name, *xs)
        err = float(np.abs(got - want).max())
        tol = REL_TOL * float(np.abs(want).max())
        print(f"[mp] (d) mesh serving {name}: a batch of 4 on {list(devices)} in {n} chunks "
              f"of {4 // n}, launches (K3, K4, K1, K4 TP) {counts} vs the one-device chunks "
              f"{chunk}; "
              f"scores vs the one-device chunks max abs {err} (bit-equal "
              f"{bool(np.array_equal(got, want))}, tol {tol}: {TOL_REASON}), vs the one-device "
              f"batch of 4 max abs {float(np.abs(got - whole).max())}; {ms:.1f} ms ({card})")
        if counts != chunk or not err <= tol:
            raise AssertionError(f"mesh serving {name}: launches {counts} vs {chunk}, "
                                 f"scores {err} > {tol}")
    print("[mp] (d) the mesh engine's prompt_model is the monolithic PromptModel "
          f"(score cache {meshed.models['prompt_model'].score_cache})")


def phase_model_parallel(K, launches: dict, card: str, tmp: str, unet_refs: dict,
                         world: int = 2) -> None:
    """Phase 16 (module docstring): (a) TP, (b) PP and (c) SP in 2 ranks
    sharing the card (children of this script, gloo), each against one
    process on the same weights and inputs; (d) mesh serving; (e) times.
    With `world` 4 on four cards the ranks take a card each over NCCL:
    (a) and (b) on a (2 x 2) mesh, each data row holding every row, (c) in
    4 shards of 64 rows, (d) over the four cards."""
    import dataclasses
    import os

    from image_segmentation_tpu_torch import config as C
    from image_segmentation_tpu_torch.models.clip_vit import ClipViT, ClipViTConfig
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import train_step

    rng = np.random.default_rng(16)
    cfg = C.CLIPUNET
    clip = C.build_model(cfg, "cuda", torch.Generator().manual_seed(0))
    _perturb_batchnorm_(clip, 16)
    clip_init = {k: v.detach().cpu().clone() for k, v in clip.state_dict().items()}
    clip_x = torch.from_numpy(rng.uniform(0, 1, (8, 224, 224, 3)).astype(np.float32)).cuda()
    n_step = cfg.batch_size * cfg.accum_steps
    step_x = torch.from_numpy(rng.uniform(0, 1, (n_step, 224, 224, 3)).astype(np.float32))
    step_y = torch.from_numpy(rng.integers(0, 4, (n_step, 224, 224)))
    f32 = C.build_model(dataclasses.replace(cfg, use_kernels=False), "cuda",
                        torch.Generator().manual_seed(0))
    f32.load_state_dict(clip_init)
    f32.dtype = torch.float32
    with torch.inference_mode():
        one_tp, f32_tp = clip(clip_x).cpu(), f32(clip_x).cpu()
        one_tp_ms = _timed_ms(lambda: clip(clip_x))
        # (b)'s references: the ViT's hidden states, bf16 kernels and f32 plain
        vit = clip.vision_model
        _, hid = vit(clip_x.to(torch.bfloat16))
        pp_x0 = hid[0].cpu()
        one_pp = [h.cpu() for h in hid[1:]]
        _, hid32 = f32.vision_model(clip_x)
        f32_pp = [h.cpu() for h in hid32[1:]]
        one_pp_ms = _timed_ms(lambda: vit(clip_x.to(torch.bfloat16)))
    st = TrainState(clip, *C.build_optimizer(cfg, clip))
    one_step_loss = float(train_step(st, C.build_loss(cfg), step_x.cuda(), step_y.cuda(),
                                     cfg.accum_steps))
    one_step_ms = _timed_ms(lambda: train_step(st, C.build_loss(cfg), step_x.cuda(),
                                               step_y.cuda(), cfg.accum_steps), iters=1)
    del clip, f32, st, vit, hid, hid32
    # (c)'s references: the UNet-64 eval forward through K1 and through the
    # f32 module path, at 256 px, batch 8
    ucfg = C.UNET_NOAUG
    unet = C.build_model(ucfg, "cuda", torch.Generator().manual_seed(1))
    _perturb_batchnorm_(unet, 17)
    unet_init = {k: v.detach().cpu().clone() for k, v in unet.state_dict().items()}
    unet_x = torch.from_numpy(rng.uniform(0, 1, (8, 256, 256, 3)).astype(np.float32)).cuda()
    with torch.inference_mode():
        one_sp = unet(unet_x).cpu()
        one_sp_ms = _timed_ms(lambda: unet(unet_x))
        unet.use_kernels, unet.dtype = False, torch.float32
        f32_sp = unet(unet_x).cpu()
    del unet
    torch.cuda.empty_cache()
    inputs = os.path.join(tmp, "mp_inputs.pt")
    torch.save({"clip": clip_init, "clip_x": clip_x.cpu(), "clip_step_x": step_x,
                "clip_step_y": step_y, "pp_x0": pp_x0, "unet": unet_init,
                "unet_x": unet_x.cpu(), "unet_step_init": unet_refs["init"],
                "unet_step_x": unet_refs["x"], "unet_step_y": unet_refs["y"]}, inputs)
    del clip_x, unet_x
    torch.cuda.empty_cache()

    procs = _dp_start("mp", world, tmp, {"inputs": inputs})
    res = _dp_wait(procs)
    out = [torch.load(p[1] + ".pt") for p in procs]
    for r in res:
        for key in ("tp_counts", "tp_step_counts", "pp_counts", "sp_counts"):
            _add_counts(launches, r[key][:3])
            launches["fused_mlp_partial"] += r[key][3]
    failed = []
    # (a) TP
    err, bound = _own_bound(out[0]["tp"], one_tp, f32_tp)
    n_vit = cfg.accum_steps * 12
    print(f"[mp] (a) TP, full-width ClipUNet (ViT-B/16, 224 px, B 8, bf16, K3/K4 on), "
          f"dp{world // 2} x tp2, {world} ranks ({res[0]['backend']}): logits rel L2 from the f32 "
          f"forward {err:.3e}, bound {bound:.3e} (1.5x one process's bf16 forward's); ranks "
          f"equal {torch.equal(out[0]['tp'], out[1]['tp'])}; launches (K3, K4, K1, K4 TP) per "
          f"rank {[r['tp_counts'] for r in res]}, want (12, 0, 0, 12)")
    if not (err <= bound and torch.equal(out[0]["tp"], out[1]["tp"])
            and all(tuple(r["tp_counts"]) == (12, 0, 0, 12) for r in res)):
        failed.append("TP forward")
    rel = abs(res[0]["tp_step_loss"] - one_step_loss) / abs(one_step_loss)
    print(f"[mp] (a) TP, one clipunet in-line step (micro {cfg.batch_size} x accum "
          f"{cfg.accum_steps}, frozen ViT under TP): loss {res[0]['tp_step_loss']:.6f} / "
          f"{res[1]['tp_step_loss']:.6f} vs one process {one_step_loss:.6f} (rel {rel:.2e}, "
          f"bound {BF16_LOSS_RTOL}); launches per rank {[r['tp_step_counts'] for r in res]}, "
          f"want ({n_vit}, 0, 0, {n_vit})")
    if not (rel <= BF16_LOSS_RTOL and res[0]["tp_step_loss"] == res[1]["tp_step_loss"]
            and all(tuple(r["tp_step_counts"]) == (n_vit, 0, 0, n_vit) for r in res)):
        failed.append("TP step")
    # (b) PP
    per_stage = PP_MICRO * 12 // PP_STAGES
    worst = max((_own_bound(out[0]["pp_layers"][i], one_pp[i], f32_pp[i]) for i in range(12)),
                key=lambda eb: eb[0] / max(eb[1], 1e-300))
    fin = _own_bound(out[0]["pp_final"], one_pp[-1], f32_pp[-1])
    same = all(torch.equal(out[0][k], out[1][k]) for k in ("pp_final", "pp_layers"))
    print(f"[mp] (b) PP, ViT-B/16's 12 blocks in {PP_STAGES} stages of 6, M = {PP_MICRO} at "
          f"B 8, forward: final rel L2 from f32 {fin[0]:.3e} (bound {fin[1]:.3e}), the "
          f"per-layer state nearest its bound {worst[0]:.3e} (bound {worst[1]:.3e}); stages "
          f"equal {same}; launches (K3, K4, K1, K4 TP) per stage "
          f"{[r['pp_counts'] for r in res]}, want ({per_stage}, {per_stage}, 0, 0) (bubble "
          f"ticks skipped)")
    if not (fin[0] <= fin[1] and worst[0] <= worst[1] and same
            and all(tuple(r["pp_counts"]) == (per_stage, per_stage, 0, 0) for r in res)):
        failed.append("PP forward")
    # (c) SP
    sp_logits = torch.cat([o["sp"] for o in out], dim=1)
    err, bound = _own_bound(sp_logits, one_sp, f32_sp)
    print(f"[mp] (c) SP, UNet-64 at 256 px, B 8, {world} shards of {256 // world} rows, eval "
          f"through K1 on "
          f"haloed slabs: logits rel L2 from the f32 module path {err:.3e}, bound {bound:.3e} "
          f"(1.5x one process's K1 forward's); vs one process max abs "
          f"{float((sp_logits - one_sp).abs().max()):.3e}; launches per rank "
          f"{[r['sp_counts'] for r in res]}, want (0, 0, 9, 0)")
    unchecked = [_unchecked_slabs(r["sp_slabs"]) for r in res]
    print(f"[mp] (c) SP, the slabs K1 ran on, rank 0 {res[0]['sp_slabs']}, last rank "
          f"{res[-1]['sp_slabs']}; not held against the plain version in phase 3: {unchecked}")
    if not (err <= bound and all(tuple(r["sp_counts"]) == (0, 0, 9, 0) for r in res)
            and not any(unchecked)):
        failed.append("SP forward")
    init, bf16s, f32s = unet_refs["init"], unet_refs["after"][torch.bfloat16], \
        unet_refs["after"][torch.float32]
    one_loss = unet_refs["losses"][torch.bfloat16]
    d_sp, d_bf16, d_f32 = (_update(init, s) for s in (out[0]["sp_state"], bf16s, f32s))
    cos_sp, cos_own = _cosine(d_sp, d_bf16), _cosine(d_bf16, d_f32)
    loss_rel = abs(res[0]["sp_step_loss"] - one_loss) / abs(one_loss)
    stat_err = max(float((out[0]["sp_state"][k] - v).abs().max() / max(1.0, float(v.abs().max())))
                   for k, v in bf16s.items() if "running" in k)
    same = all(torch.equal(out[0]["sp_state"][k], out[1]["sp_state"][k]) for k in init)
    print(f"[mp] (c) SP, one full-width step (UNet-64, 256 px, micro 8 x accum 8, bf16, module "
          f"path, 1-row halos): loss {res[0]['sp_step_loss']:.6f} vs one process "
          f"{one_loss:.6f} (rel {loss_rel:.2e}); update cosine {cos_sp:.6f} (bf16 vs f32 in one "
          f"process {cos_own:.6f}); running statistics max scaled diff {stat_err:.3e}; ranks' "
          f"states equal {same}")
    if not (loss_rel <= BF16_LOSS_RTOL and stat_err <= BF16_STAT_TOL and same
            and 1 - cos_sp <= BF16_GRAD_RATIO * (1 - cos_own)):
        failed.append("SP step")
    # (e) times
    ms = lambda r, k: [round(t, 2) for t in r[k]]  # noqa: E731
    print(f"[mp] (e) ms (perf_counter around synchronised calls), {world} ranks "
          f"({res[0]['backend']}) against one process: TP forward "
          f"{[ms(r, 'tp_ms') for r in res]} vs {[round(t, 2) for t in one_tp_ms]}; TP step {[ms(r, 'tp_step_ms') for r in res]} vs "
          f"{[round(t, 2) for t in one_step_ms]}; PP forward {[ms(r, 'pp_ms') for r in res]} vs "
          f"the ViT in one process {[round(t, 2) for t in one_pp_ms]}; SP eval "
          f"{[ms(r, 'sp_ms') for r in res]} vs {[round(t, 2) for t in one_sp_ms]}; SP step "
          f"{[ms(r, 'sp_step_ms') for r in res]} vs {[round(t, 2) for t in unet_refs['one_ms']]} "
          f"({card}); {HOST_COLLECTIVES if res[0]['backend'] == 'gloo' else 'NCCL'}")
    if failed:
        raise AssertionError(f"phase 16: {failed} out of bounds (lines above)")
    phase_mesh_serving(K, launches, card, tuple(f"cuda:{i % torch.cuda.device_count()}"
                                               for i in range(max(2, world))))


STUDY_LABEL = "1 epoch / random-init ViT: not a quality result"


def _eval_batches_of(labels, batch: int) -> int:
    """The device eval's batches over a val set with these native label
    maps: its canvas-size buckets (16 or more images), each cut into batches
    of `batch`."""
    from image_segmentation_tpu_torch.train.fast_eval import plan_size_buckets

    plan = plan_size_buckets(labels) if len(labels) >= 16 else [range(len(labels))]
    return sum(-(-len(b) // batch) for b in plan)


def _split_eval_batches(tree: str, split: str, batch: int) -> int:
    """The device-protocol eval batches over one split of a prepared tree:
    its canvas-size buckets (16 or more images), each cut into batches."""
    import os

    from PIL import Image

    ldir = os.path.join(tree, split, "label")
    labels = []
    for f in sorted(os.listdir(ldir)):
        with Image.open(os.path.join(ldir, f)) as im:
            labels.append(np.zeros((im.height, im.width), np.uint8))
    return _eval_batches_of(labels, batch)


@contextlib.contextmanager
def _plain_config(name: str):
    """run.main builds config `name` with the kernels off while inside."""
    import dataclasses

    from image_segmentation_tpu_torch import config as C

    kept = C.CONFIGS[name]
    C.CONFIGS[name] = dataclasses.replace(kept, use_kernels=False)
    try:
        yield
    finally:
        C.CONFIGS[name] = kept


def _logged(log_path: str, fn, *args):
    """fn(*args) with its stdout appended to log_path; on an error, the
    log's last lines go to stderr before the error propagates."""
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args)
    except BaseException:
        print("\n".join(buf.getvalue().splitlines()[-40:]), file=sys.stderr)
        raise
    finally:
        with open(log_path, "a") as f:
            f.write(buf.getvalue())


def unet_levels(side: int, cin: int, base: int):
    """unet64_levels for a UNet of another base width."""
    return [(h, ci if i == 0 else ci * base // 64, c * base // 64)
            for i, (h, ci, c) in enumerate(unet64_levels(side, cin))]


# The K1 shapes phase 17 adds to phase 3's, as (N, side, stem Cin, base):
# the ablations' base-32 UNets, whose eval batch is 32 at 256 px and 8 at
# 512 px, and their prompt model's base-32 selection UNet (Cin 4, 224 px)
# at N = 32; the sweep's batch on the 256 px UNet-64 is added at run time.
STUDY_UNETS = ((32, 256, 3, 32), (8, 512, 3, 32), (32, 224, 4, 32))
# K3 and K4 at the ablations' frozen ViT (hidden 128 in 2 heads of 64, MLP
# 256; 224 px, batch 32): (B, S, H, D) and (tokens, hidden, F).
STUDY_ATTENTION = (32, 197, 2, 64)
STUDY_MLP = (32 * 197, 128, 256)


def check_study_kernels(K, sweep_batch: int) -> dict:
    """K1 (and its concat entry), K3 and K4 at the shapes phase 17 gives
    them that phase 3 does not check (STUDY_UNETS and the sweep's batch
    of `sweep_batch` on the UNet-64), each against its plain version within
    two bf16 steps; returns the largest error by kernel."""
    A, M, D = K
    g = torch.Generator(device="cuda").manual_seed(17)
    cases, cat_cases = [], []
    for n, side, cin, base in STUDY_UNETS + ((sweep_batch, 256, 3, 64),):
        levels = unet_levels(side, cin, base)
        cases += [((n, h, h, ci), c, 0.0) for h, ci, c in levels]
        cat_cases += [((n, h, h), ci // 2, ci // 2, c) for h, ci, c in levels[5:]]
    k1 = max(check_double_conv(D, g, cases, cat_cases))
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    q, k, v = (rnd(*STUDY_ATTENTION).bfloat16() for _ in range(3))
    got = A.fused_attention(q, k, v)
    torch.cuda.synchronize()
    k3 = _compare(f"attention {STUDY_ATTENTION}", got, A.attention_reference(q, k, v))
    m, h, f = STUDY_MLP
    args = ((0.5 * rnd(1, m, h)).bfloat16(), 1.0 + 0.1 * rnd(h), 0.1 * rnd(h),
            (rnd(f, h) / h ** 0.5).bfloat16(), 0.1 * rnd(f), (rnd(h, f) / f ** 0.5).bfloat16(),
            0.1 * rnd(h), 1e-5)
    got = M.fused_mlp(*args)
    torch.cuda.synchronize()
    k4 = _compare(f"mlp tokens={m} {h}->{f}->{h}", got, M.mlp_reference(*args))
    return {"fused_attention": k3, "fused_mlp": k4, "fused_double_conv": k1}


def phase_study(K, launches: dict, card: str, tmp: str) -> dict:
    """Phase 17 (module docstring): the reference study on the card at full
    width, through the port's study modules as a user runs them. Returns
    the largest error of each kernel against its plain version at the
    shapes this phase adds."""
    import os

    from image_segmentation_tpu_torch import run as R
    from image_segmentation_tpu_torch.scripts import fullscale, reproduce_reference
    from image_segmentation_tpu_torch.studies import ablations
    from image_segmentation_tpu_torch.studies.robustness import PERTURBATIONS, robustness_sweep
    from image_segmentation_tpu_torch.studies.robustness_pipeline import (
        load_row_model,
        materialize_test_split,
    )
    from image_segmentation_tpu_torch.train.state import TrainState
    from image_segmentation_tpu_torch.train.steps import eval_forward

    work = os.path.join(tmp, "study")
    os.makedirs(work)
    log = os.path.join(work, "study.log")
    tree, runs = os.path.join(work, "tree"), os.path.join(work, "runs")
    walls = {}

    # (a) the converged-run script at 1 epoch: pseudo-Pet source, prepare,
    # unet_aug (offline augmentation) and unet_noaug at UNet-64, 256 px, and
    # the 8 x 10 device-path sweep of both on Test
    _zero(K)
    t0 = time.time()
    fs = _logged(log, fullscale.main, [
        "--workdir", work, "--images", "64", "--epochs", "1", "--patience", "0",
        "--batch", "8", "--target-size", "256", "--device", "cuda"])
    walls["fullscale"] = time.time() - t0
    counts_a = _counts(K)
    _add(launches, K)
    n_test = len(os.listdir(os.path.join(tree, "Test", "color")))
    sweep_batches = len(PERTURBATIONS) * 10 * -(-n_test // 64)
    # the sweep runs batches of min(64, n_test) images
    evals = _split_eval_batches(tree, "Val", 8) + _split_eval_batches(tree, "Test", 8)
    want_a = (0, 0, 9 * 2 * (evals + sweep_batches))
    sweep_s = fs["total_wall_s"] - fs["train_wall_s"]
    print(f"[study] (a) fullscale --images 64 --epochs 1 --batch 8 --target-size 256: "
          f"{walls['fullscale']:.1f} s (train rows {fs['train_wall_s']} s); {n_test} Test "
          f"images; launches (attention, mlp, double_conv) {counts_a}, want {want_a}; sweep "
          f"{2 * len(PERTURBATIONS) * 10 * n_test / sweep_s:.1f} images/s (2 rows x 80 cells "
          f"x {n_test} images over {sweep_s:.1f} s, the Test split's materialisation "
          f"included) ({card})")
    for row, m in fs["table"].items():
        print(f"[study] (a) {row} Test: acc {m['acc']!r} dice {m['dice']!r} iou {m['iou']!r} "
              f"({STUDY_LABEL})")
    print(f"[study] (a) mean Dice gap aug - noaug by family "
          f"{fs['robustness_mean_dice_gap_aug_minus_noaug']}, aug wins "
          f"{fs['robustness_aug_wins']} of 8 ({STUDY_LABEL})")
    curves = fs["robustness_curves"]
    finite = all(np.isfinite(v).all() and len(v) == 10 for cv in curves.values()
                 for v in cv.values())
    if counts_a != want_a or set(curves) != {"unet_aug", "unet_noaug"} or not finite:
        raise AssertionError(f"fullscale: launches {counts_a} against {want_a}, curves "
                             f"{curves}")
    errs = check_study_kernels(K, min(64, n_test))

    # (b) the rest of the table on the same tree and in the same runs
    # directory, the CLIP rows on a converted full-width ViT-B/16
    npz = _write_clip_npz(work, seed=17)
    _zero(K)
    t0 = time.time()
    table = _logged(log, reproduce_reference.main, [
        "--data-root", tree, "--save-dir", runs, "--rows",
        "clip_aug,clip_noaug,autoencoder,prompt", "--epochs", "1", "--batch-size", "8",
        "--clip-weights", npz, "--device", "cuda", "--json-out",
        os.path.join(work, "repro_table.json")])
    walls["reproduce"] = time.time() - t0
    counts_b = _counts(K)
    _add(launches, K)
    test_b = _split_eval_batches(tree, "Test", 8)
    print(f"[study] (b) reproduce_reference clip_aug,clip_noaug,autoencoder,prompt --epochs 1 "
          f"--batch-size 8 --clip-weights (ViT-B/16, random): {walls['reproduce']:.1f} s; "
          f"launches {counts_b} ({card})")
    for row, m in table.items():
        print(f"[study] (b) {row} Test: acc {m['acc']!r} dice {m['dice']!r} iou {m['iou']!r} "
              f"({STUDY_LABEL})")
    ok = (set(table) == {"clip_aug", "clip_noaug", "autoencoder", "prompt"}
          and all(0.0 <= m["iou"] <= m["dice"] <= 1.0 for m in table.values()))
    # 12 K3/K4 launches a ViT forward: at least the three CLIP-family rows'
    # Test evals; K1 at least the prompt row's Test eval (its selection UNet)
    if not (ok and counts_b[0] == counts_b[1] >= 12 * 3 * test_b and counts_b[2] >= 9 * test_b):
        raise AssertionError(f"reproduce_reference: {table}, launches {counts_b}")

    # (c) each kernel against its plain version on this path: the best
    # unet_noaug and prompt checkpoints re-scored on Test with the kernels
    # off, and the sweep's u8 device path against its host path
    _zero(K)
    t0 = time.time()
    for row, m in (("unet_noaug", fs["table"]["unet_noaug"]), ("prompt", table["prompt"])):
        with _plain_config(row):
            plain = _logged(log, R.main, [
                "--config", row, "--data-root", tree, "--evaluate", os.path.join(runs, row, row),
                "--split", "Test", "--batch-size", "8", "--device", "cuda"])
        gaps = {k: abs(float(plain[k]) - m[k]) for k in ("acc", "dice", "iou")}
        print(f"[study] (c) {row} Test through the kernels vs the plain versions: gaps "
              f"{gaps} (tolerance 2e-3 each); plain acc {float(plain['acc'])!r} dice "
              f"{float(plain['dice'])!r} iou {float(plain['iou'])!r} ({card})")
        if not all(g <= 2e-3 for g in gaps.values()):
            raise AssertionError(f"{row}: kernel and plain Test metrics differ by {gaps}")
    if _counts(K) != (0, 0, 0):
        raise AssertionError(f"the plain re-scores launched kernels: {_counts(K)}")
    val = materialize_test_split(tree, 256)
    model = load_row_model(runs, "unet_noaug", "cuda")
    kw = dict(severities=[3, 8], families=["gaussian_noise", "brightness_up"], verbose=False,
              batch_size=64)
    host = robustness_sweep(lambda x: eval_forward(model, x).float(), val, device="cuda", **kw)
    dev = robustness_sweep(None, val, state=TrainState(model), **kw)
    gap = max(abs(a - b) for k in host for a, b in zip(host[k], dev[k]))
    print(f"[study] (c) sweep, u8 device path vs host path, 2 families x 2 severities: "
          f"max Dice gap {gap!r} (tolerance 5e-3); {time.time() - t0:.1f} s ({card})")
    if not gap <= 5e-3:
        raise AssertionError(f"sweep device path vs host path: {dev} against {host}")
    del model

    # (d) the report's controlled comparisons at 32 images, 1 epoch each
    _zero(K)
    t0 = time.time()
    abl = _logged(log, ablations.main, [
        "--images", "32", "--epochs", "1", "--clip-pre-epochs", "1", "--clip-epochs", "1",
        "--device", "cuda"])
    walls["ablations"] = time.time() - t0
    counts_d = _counts(K)
    _add(launches, K)
    print(f"[study] (d) ablations, all five, --images 32 --epochs 1 --clip-pre-epochs 1 "
          f"--clip-epochs 1 (ViT hidden {abl['config']['vit_hidden']}, "
          f"{abl['config']['vit_heads']} heads): {walls['ablations']:.1f} s; launches "
          f"{counts_d} ({card})")
    for s in abl["summaries"]:
        print(f"[study] (d) {s['summary']}: mIoU {s['miou']} epoch s {s['epoch_s']} "
              f"({STUDY_LABEL})")
    want_exp = {"loss", "weights", "skips", "resolution", "prompt_freeze"}
    if {s["summary"] for s in abl["summaries"]} != want_exp or not all(c > 0 for c in counts_d) \
            or counts_d[0] != counts_d[1]:
        raise AssertionError(f"ablations: {abl['summaries']}, launches {counts_d}")
    print(f"[study] wall s {({k: round(v, 1) for k, v in walls.items()})}; launches counted "
          f"(a) {counts_a} (b) {counts_b} (d) {counts_d}; log {os.path.getsize(log)} bytes")
    return errs


def serve_profile_masks() -> dict:
    """The masks (argmax of the float32 scores at the model's 256 px) of
    serve_profile's request through its seeded UNet: the K1 forward, the
    module path in bf16 and the module path in float32."""
    from image_segmentation_tpu_torch.probes import serve_profile
    from image_segmentation_tpu_torch.serve.engine import stage_request

    masks = {}
    for name, kernels, dtype in (("k1", True, None), ("module", False, None),
                                 ("f32", False, torch.float32)):
        engine, model = serve_profile.build(256, "cuda", use_kernels=kernels)
        model.dtype = dtype or model.dtype
        (staged,), _ = stage_request(serve_profile.image(), engine.models["unet"], None, True)
        x = torch.from_numpy(staged[None]).cuda().float() / 255.0
        with torch.inference_mode():
            masks[name] = model(x)[0].argmax(-1)
    return masks


def _probe(K, launches: dict, shapes_seen: list, walls: dict, name: str, fn, *args):
    """One probe's main through its entry point, its K1 shapes recorded and
    its launches counted from 0; returns (result, launches of this run)."""
    _zero(K)
    t0 = time.time()
    with _recording_k1_shapes() as shapes:
        out = fn(*args)
    walls[name] = time.time() - t0
    counts = _counts(K)
    _add(launches, K)
    shapes_seen += shapes
    return out, counts


def phase_probes(K, launches: dict, card: str, tmp: str) -> float:
    """Phase 18 (module docstring): the speed probes and parity rehearsals
    at full width through their `main`s, short counts. Returns K1's largest
    error against its plain version at the shapes this phase gave it that
    phase 3 does not check."""
    import os

    from image_segmentation_tpu_torch.probes import (
        backward_anatomy,
        confusion_probe,
        eval_bench,
        profile_train_step,
        reference_anchor,
        serve_profile,
        step_variants,
    )
    from image_segmentation_tpu_torch.studies import ablations, bn_regime, convergence_rehearsal

    A, M, D = K
    shapes, walls = [], {}
    probe = lambda *a: _probe(K, launches, shapes, walls, *a)  # noqa: E731

    # (a) the confusion formulations on eval-protocol canvases
    conf, counts = probe("confusion_probe", confusion_probe.main,
                         ["--iters", "10", "--repeat", "2", "--device", "cuda"])
    if not conf["counts_equal"] or counts != (0, 0, 0):
        raise AssertionError(f"confusion_probe: {conf}, launches {counts}")

    # (b) eval_bench at 128 images, both protocols; K1 against the module path
    eb, counts = probe("eval_bench", eval_bench.main, ["--images", "128", "--device", "cuda"])
    dev_row = eb["rows"][0]
    dev_batches = sum(-(-b["images"] // 16) for b in dev_row["bucket_plan"])
    want = 9 * (2 * dev_batches + -(-128 // 16))  # device: untimed + timed; host once
    val, plain, _ = eval_bench.setup(128, False, "cuda", use_kernels=False)
    _, plain_m = eval_bench.measure(plain, val, ["device"], 16)
    gaps = {k: abs(float(plain_m["device"][m]) - dev_row[k])
            for k, m in (("dice", "dice"), ("miou", "iou"), ("val_loss", "loss"))}
    print(f"[probes] (b) eval_bench --images 128: device {dev_row['value']!r} images/s, host "
          f"{eb['rows'][1]['value']!r} images/s, metrics_match_host_oracle "
          f"{eb['metrics_match_host_oracle']}, bit-identical {eb['metrics_bit_identical']}; "
          f"launches {counts}, want K1 {want}; K1 device metrics vs the module path's: gaps "
          f"{gaps} (tolerance 2e-3) ({card})")
    if not eb["metrics_match_host_oracle"] or counts != (0, 0, want) \
            or not all(g <= 2e-3 for g in gaps.values()):
        raise AssertionError(f"eval_bench: {eb}, launches {counts}, gaps {gaps}")
    del val, plain

    # (c) serve_profile at 20 steps; the K1 mask against the module path's
    steps = 20
    sp, counts = probe("serve_profile", serve_profile.main, ["--steps", str(steps),
                                                            "--device", "cuda"])
    want = 9 * (2 + 3 * (steps + 1))  # warm-up, one dispatch, forward / fetch / e2e
    # Random weights on a noise image leave near-ties everywhere: bf16 alone
    # moves the module path's mask off the float32 forward's on about 0.6% of
    # the pixels, so K1's mask is held to the module path's within 0.01 and
    # to the float32 mask no worse than the module path's bf16 mask is
    masks = serve_profile_masks()
    agree = lambda a, b: float((masks[a] == masks[b]).float().mean())  # noqa: E731
    pairs = {"k1_vs_module": agree("k1", "module"), "k1_vs_f32": agree("k1", "f32"),
             "module_vs_f32": agree("module", "f32")}
    print(f"[probes] (c) serve_profile --steps {steps}: stage {sp['stage_ms']!r} ms, upload "
          f"{sp['upload_ms']!r}, forward {sp['forward_ms']!r}, fetch {sp['fetch_ms']!r}, "
          f"unstage {sp['unstage_ms']!r}, e2e {sp['e2e_ms']!r}; launches {counts}, want K1 "
          f"{want}; masks (argmax of float32 scores) agree on these shares of pixels: "
          f"{pairs} (want K1 vs module >= 0.99, K1 vs f32 >= module vs f32 - 1e-3) ({card})")
    if counts != (0, 0, want) or pairs["k1_vs_module"] < 0.99 \
            or pairs["k1_vs_f32"] < pairs["module_vs_f32"] - 1e-3:
        raise AssertionError(f"serve_profile: launches {counts}, mask agreement {pairs}")

    # (d)-(g) the train step's probes (module path: no kernel launches)
    pts, c_d = probe("profile_train_step", profile_train_step.main,
                     ["--steps", "5", "--device", "cuda"])
    sv, c_e = probe("step_variants", step_variants.main,
                    ["--steps", "3", "--turns", "1", "--device", "cuda"])
    ba, c_f = probe("backward_anatomy", backward_anatomy.main,
                    ["--per-conv", "--steps", "3", "--device", "cuda"])
    ra, c_g = probe("reference_anchor", reference_anchor.main,
                    ["--mode", "torch-samechip", "--steps", "64", "--device", "cuda"])
    print(f"[probes] (d) profile_train_step: step {pts['step']!r} ms, {pts['img_per_sec']!r} "
          f"images/s, peak {pts['peak_memory_bytes']} bytes; (e) step_variants images/s "
          f"{sv['img_per_sec']}; (f) backward_anatomy: device {ba['device_total_ms']!r} ms a "
          f"step, attributed {ba['attributed_share']!r}, bwd/fwd {ba['bwd_over_fwd']!r}, "
          f"outside the convs {ba['per_conv']['outside_conv_share']!r}; (g) torch-samechip "
          f"{ra['images_per_sec']!r} images/s; launches {c_d} {c_e} {c_f} {c_g} ({card})")
    if abs(ba["attributed_share"] - 1.0) > 0.02 or any(sum(c) for c in (c_d, c_e, c_f, c_g)) \
            or set(sv["img_per_sec"]) != set(step_variants.VARIANTS):
        raise AssertionError(f"train-step probes: anatomy {ba}, variants {sv}, launches "
                             f"{c_d} {c_e} {c_f} {c_g}")

    # (h) bn_regime, one seed per arm, 1 epoch, at its default sizes
    bn, counts = probe("bn_regime", bn_regime.main, ["--seeds", "1", "--epochs", "1",
                                                     "--device", "cuda"])
    labels = [l for _, l in ablations.hard_synthetic_items(64, 100)]
    want = 9 * sum(_eval_batches_of(labels, b) for _, b, _ in bn_regime.arms(True))
    print(f"[probes] (h) bn_regime --seeds 1 --epochs 1: best Dice "
          f"{ {r['arm']: r['best_dice'] for r in bn['rows']} }; launches {counts}, want K1 "
          f"{want} (1 epoch: not a quality result) ({card})")
    if counts != (0, 0, want) or [r["micro_batch"] for r in bn["rows"]] != [2, 64, 128]:
        raise AssertionError(f"bn_regime: {bn['rows']}, launches {counts}")

    # (i) convergence_rehearsal at 2 epochs with its first-step check
    cr, counts = probe("convergence_rehearsal", convergence_rehearsal.main, [
        "--epochs", "2", "--device", "cuda", "--out", os.path.join(tmp, "rehearsal.json")])
    labels = [l for _, l in ablations.hard_synthetic_items(24, 99)]
    want = 9 * 2 * _eval_batches_of(labels, 8)
    print(f"[probes] (i) convergence_rehearsal --epochs 2: first step rel "
          f"{cr['rel_drift']['first_step']!r}, first epoch max rel "
          f"{cr['rel_drift']['first_epoch_max']!r}, checks {cr['checks']}; launches {counts}, "
          f"want K1 {want} ({card})")
    if not cr["checks"]["first_step_rel_lt_1e-3"] or counts != (0, 0, want):
        raise AssertionError(f"convergence_rehearsal: {cr['rel_drift']}, launches {counts}")

    # K1 against its plain version at every shape this phase gave it that
    # phase 3 does not check
    k1 = {(tuple(x), c) for x, c, _ in K1_CASES}
    cat = {(nhw, cs, cu, c) for nhw, cs, cu, c in K1_CAT_CASES}
    cases = sorted({(tuple(sh[0]), sh[1]) for sh in shapes if len(sh) == 2} - k1)
    cat_cases = sorted({(tuple(sh[0]), *sh[1:]) for sh in shapes if len(sh) == 4} - cat)
    g = torch.Generator(device="cuda").manual_seed(18)
    errs = check_double_conv(D, g, [(x, c, 0.0) for x, c in cases], cat_cases)
    print(f"[probes] K1 at {len(cases)} new shapes and its concat entry at {len(cat_cases)} "
          f"against the plain version: largest error {max(errs)!r}; wall s "
          f"{ {k: round(v, 1) for k, v in walls.items()} } ({card})")
    return max(errs)


def _card_line() -> str:
    """The first card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def four_cards() -> int:
    """Phase 16 over four cards, one rank a card over NCCL: (a) and (b) on a
    (2 x 2) mesh, each data row holding every row, (c) in 4 shards of 64
    rows, (d) over the four cards; first K3 at a TP rank's heads and K1 at
    every SP slab are held against their plain versions. The smoke itself
    (no arguments) needs one card; this needs four, and runs as

        python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.four_cards())'
    """
    import tempfile

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("four_cards: needs four cards", file=sys.stderr)
        return 1
    from image_segmentation_tpu_torch.ops.kernels import _build
    from image_segmentation_tpu_torch.ops.kernels import attention as A
    from image_segmentation_tpu_torch.ops.kernels import double_conv as D
    from image_segmentation_tpu_torch.ops.kernels import mlp as M

    card = _card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}")
    _build.build()
    _build.load()
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(8, 197, 384, generator=g, device="cuda").bfloat16()
               .view(8, 197, 6, 64) for _ in range(3))
    _compare("attention (8, 197, 6, 64)", A.fused_attention(q, k, v),
             A.attention_reference(q, k, v))
    check_double_conv(D, g, [c for c in K1_CASES if c[0][0] == 8 and c[0][1] != c[0][2]],
                      [c for c in K1_CAT_CASES if c[0][0] == 8])
    launches = dict.fromkeys(KERNEL_NAMES + ("fused_mlp_partial",), 0)
    with tempfile.TemporaryDirectory() as tmp:
        refs = unet_step_refs()
        t0 = time.time()
        phase_model_parallel((A, M, D), launches, card, tmp, refs, world=4)
    print(f"[phase 16, 4 cards] {time.time() - t0:.1f} s; launches {launches}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _header_version(header: str) -> str:
    """The library version a header declares (PNG_LIBPNG_VER_STRING,
    JPEG_LIB_VERSION), through the preprocessor."""
    import subprocess

    macro = {"png.h": "PNG_LIBPNG_VER_STRING", "jpeglib.h": "JPEG_LIB_VERSION"}[header]
    src = f"#include <stdio.h>\n#include <{header}>\nistpu_version {macro}\n"
    out = subprocess.run(["g++", "-E", "-P", "-x", "c++", "-"], input=src, capture_output=True,
                         text=True, timeout=60).stdout
    return next((l.split(None, 1)[1] for l in out.splitlines()
                 if l.startswith("istpu_version")), "?")


def print_ptxas_report(log: str) -> None:
    """One line per kernel from ptxas's -v report: registers, spills."""
    import re

    name = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
        elif name and ("spill" in line or "Used" in line):
            print(f"[build] ptxas {name[:90]}: {line.split(':', 1)[-1].strip()}")


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-child":
        return dp_child(json.loads(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from image_segmentation_tpu_torch.ops.kernels import _build
    from image_segmentation_tpu_torch.ops.kernels import attention as A
    from image_segmentation_tpu_torch.ops.kernels import double_conv as D
    from image_segmentation_tpu_torch.ops.kernels import mlp as M

    card = _card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    start = t0 = time.time()
    log = _build.build()
    _build.load()
    print(f"[build] nvcc built {_build.LIB_PATH} from {_build.SOURCES} "
          f"in {time.time() - t0:.2f} s")
    print_ptxas_report(log)

    def timed(phase, *args):
        t0 = time.time()
        out = phase(*args)
        print(f"[{phase.__name__}] {time.time() - t0:.1f} s")
        return out

    timing = timed(phase_kernels, A, M, D, card)
    timing["relpos_attention"], k4_gelu, sam_launches = timed(phase_sam_kernels, M, card)
    timing["fused_mlp"].update(k4_gelu)
    launches, eng, clip = timed(phase_serving, A, M, card)
    launches["relpos_attention"] = sam_launches[0]
    launches["fused_mlp"] += sam_launches[1]
    launches["fused_double_conv"], unet = timed(phase_unet, eng, card)
    K = (A, M, D)
    eng4 = timed(phase_four_families, K, clip, unet, launches, card)
    timed(phase_batched, K, eng4, clip.vit.num_layers, launches, card)
    del eng, eng4, clip, unet
    import os
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        # the MO_ directories of phases 8 and 10-12, served by phase 13
        models_dir = os.path.join(tmp, "models")
        os.makedirs(models_dir)
        timed(phase_training, K, launches, card, models_dir)
        timed(phase_unet_aug, K, launches, card)
        timed(phase_autoencoder, K, launches, card, models_dir)
        mo = timed(phase_clip_training, K, launches, card, tmp)
        timed(phase_prompt_training, K, launches, card, mo, tmp)
        shutil.copytree(mo, os.path.join(models_dir, "MO_clipunet"))
        shutil.copytree(os.path.join(tmp, "prompt", "MO_prompt"),
                        os.path.join(models_dir, "MO_prompt"))
        torch.cuda.empty_cache()
        timed(phase_checkpoints, K, launches, card, models_dir, tmp)
        torch.cuda.empty_cache()
        timed(phase_host_data, K, launches, card, tmp)
        torch.cuda.empty_cache()
        unet_refs = timed(phase_data_parallel, K, launches, card, tmp)
        torch.cuda.empty_cache()
        launches["fused_mlp_partial"] = 0
        timed(phase_model_parallel, K, launches, card, tmp, unet_refs)
        torch.cuda.empty_cache()
        for name, err in timed(phase_study, K, launches, card, tmp).items():
            timing[name]["max_abs_err"] = max(timing[name]["max_abs_err"], err)
        torch.cuda.empty_cache()
        err = timed(phase_probes, K, launches, card, tmp)
        timing["fused_double_conv"]["max_abs_err"] = max(
            timing["fused_double_conv"]["max_abs_err"], err)
    print(f"[done] every phase passed in {time.time() - start:.1f} s from the build on")

    sources = {"fused_attention": ("attention.cu", "image_segmentation_tpu/ops/pallas/attention.py:99"),
               "fused_mlp": ("mlp.cu", "image_segmentation_tpu/ops/pallas/mlp.py:118"),
               "fused_mlp_partial": ("mlp.cu", "image_segmentation_tpu/ops/pallas/mlp.py:118"),
               "fused_double_conv": ("double_conv.cu",
                                     "image_segmentation_tpu/ops/pallas/double_conv.py:185"),
               "relpos_attention": ("relpos_attention.cu", None)}
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
