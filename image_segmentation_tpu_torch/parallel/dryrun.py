"""The multi-process dry run: every parallel path of the port at tiny shapes.

Counterpart of `__graft_entry__.dryrun_multichip(n)` (:36). JAX fakes n
CPU devices in one process (`xla_force_host_platform_device_count`,
:59-72); the port, one process per device, starts n CPU processes of
this module in a gloo group on a `file://` store and runs JAX's parts in
each, at JAX's shapes and seeds of numpy data (the weights are the port's
seeded initialisers):

  1.  dp: UNet base 8, 32 px, a batch of 2n as micro-batches of n × 2,
      AdamW, data-parallel over every process;
  1b. dp-multihost-feed: the same step on the rows
      `multihost.process_local_indices` gives each process;
  2.  dp{D}xtp{T}: ClipUNet with a tiny ViT (hidden 64, 4 heads, MLP 128,
      2 blocks, 32 px) on a (data, model) mesh with T = 2, the ViT's
      attention and MLP split over 'model' (parallel/tp.py);
  3.  dp-epoch-resident: a 2-step epoch from a device-resident set
      (train/steps.py `ResidentTrainSet`), each process on its rows;
  4.  sp{S}: the image height split over S = min(n, 4) processes
      (parallel/sp.py), a UNet train step at H = 16·S (with n > 4, each
      of the n / S rows of the mesh runs it);
  5.  pp{S}: GPipe over a ViT of S blocks in S stages (parallel/pp.py),
      forward and gradients;
  6.  dp-sharded-eval: the original-resolution device protocol with each
      process on its columns of each batch, pinned equal to one process's
      evaluation of the whole set (loss within 1e-6, mIoU within 1e-9).

The tiny ViT's head dim (16) is below what K3 takes on a card, so this
runs on the CPU with the kernels' plain versions; the card's
model-parallel path is chip_smoke.py's phase 16, at full width. Prints
JAX's `dryrun_multichip(n) <part>: ok, ...` lines from process 0.

Run: python -m image_segmentation_tpu_torch.parallel.dryrun [n]   (default 8)
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CHILD_TIMEOUT_S = 300


def _say(rank: int, line: str) -> None:
    if rank == 0:
        print(line, flush=True)


def _unet_state(seed: int, side: int, lr: float = 1e-3):
    from image_segmentation_tpu_torch.models.unet import UNet
    from image_segmentation_tpu_torch.train.state import TrainState, make_adamw

    model = UNet(num_classes=4, base=8).init_weights(torch.Generator().manual_seed(seed))
    model = model.to(memory_format=torch.channels_last)
    return TrainState(model, *make_adamw(model.parameters(), learning_rate=lr))


def _finite(*xs) -> None:
    for x in xs:
        if not np.isfinite(x):
            raise AssertionError(f"not finite: {xs}")


def worker(rank: int, n: int) -> None:
    """The parts, in one process of the group."""
    from image_segmentation_tpu_torch.losses import DiceCELoss
    from image_segmentation_tpu_torch.models.clip_unet import ClipUNet
    from image_segmentation_tpu_torch.models.clip_vit import (
        ClipViT,
        ClipViTConfig,
        TransformerBlock,
    )
    from image_segmentation_tpu_torch.parallel import mesh as M
    from image_segmentation_tpu_torch.parallel import pp, sp, tp
    from image_segmentation_tpu_torch.parallel.multihost import process_local_indices
    from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
    from image_segmentation_tpu_torch.train.steps import (
        ResidentTrainSet,
        local_step_rows,
        train_step,
    )

    loss_fn = DiceCELoss(ignore_index=3)
    # --- 1. UNet, data parallelism over every process, accumulation 2 ---
    mesh = M.get_mesh("cpu")
    st = _unet_state(0, 32)
    b = 2 * n
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (b, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 4, (b, 32, 32))
    rows = local_step_rows(b, 2, mesh)
    loss = float(train_step(st, loss_fn, torch.from_numpy(images[rows]),
                            torch.from_numpy(labels[rows]), accum_steps=2))
    _finite(loss)
    _say(rank, f"dryrun_multichip({n}) dp: ok, loss={loss:.4f}")

    # --- 1b. the same step on the multi-host contract's rows ---
    mine = process_local_indices(b, mesh)
    loss = float(train_step(st, loss_fn, torch.from_numpy(images[mine]),
                            torch.from_numpy(labels[mine])))
    _finite(loss)
    _say(rank, f"dryrun_multichip({n}) dp-multihost-feed: ok, loss={loss:.4f}")

    # --- 2. ClipUNet on a (data x model) mesh, TP over the ViT ---
    t = 2 if n % 2 == 0 and n >= 2 else 1
    mesh2 = M.get_mesh("cpu", model_parallel=t)
    vit = ClipViTConfig(image_size=32, patch_size=16, hidden_size=64, num_layers=2,
                        num_heads=4, mlp_dim=128)
    clip = ClipUNet(num_classes=4, vit=vit, skip_indices=(1, 2),
                    decoder_channels=(32, 16, 8)).init_weights(torch.Generator().manual_seed(1))
    tp.shard_params_tp(clip, mesh2, encoder_prefix="encoder")
    st2 = TrainState(clip, *make_adamw(clip.parameters(), learning_rate=1e-3))
    dp = n // t
    b2 = 2 * dp
    images2 = rng.uniform(0, 1, (b2, 32, 32, 3)).astype(np.float32)
    labels2 = rng.integers(0, 4, (b2, 8, 8))  # two decoder blocks from grid 2
    rows2 = local_step_rows(b2, 1, mesh2)
    loss2 = float(train_step(st2, loss_fn, torch.from_numpy(images2[rows2]),
                             torch.from_numpy(labels2[rows2])))
    _finite(loss2)
    _say(rank, f"dryrun_multichip({n}) dp{dp}xtp{t}: ok, loss={loss2:.4f}")

    # --- 3. a 2-step epoch from a resident set, each process on its rows ---
    st3 = _unet_state(2, 32)
    n3 = 2 * b
    images3 = rng.uniform(0, 1, (n3, 32, 32, 3)).astype(np.float32)
    labels3 = rng.integers(0, 4, (n3, 32, 32))
    order = np.random.default_rng(3).permutation(n3).reshape(2, b)
    mine3 = local_step_rows(b, 1, mesh)
    train = ResidentTrainSet(images3, labels3, "cpu", quantize=False)
    losses3 = [float(train_step(st3, loss_fn, *train.batch(torch.from_numpy(o[mine3]))))
               for o in order]
    _finite(*losses3)
    _say(rank, f"dryrun_multichip({n}) dp-epoch-resident: ok, "
               f"losses={np.round(losses3, 4).tolist()}")

    # --- 4. spatial partitioning: the height over min(n, 4) processes ---
    # a (n / S, S) mesh with H on 'model' and the batch on every rank: each
    # data row runs JAX's pure-SP step, and the world sums count its rows
    # n / S times over, numerator and denominator alike
    sp_n = min(n, 4)
    sp_h = 16 * sp_n
    mesh4 = M.get_mesh("cpu", model_parallel=sp_n)
    st4 = _unet_state(4, sp_h)
    sp.partition_model(st4.model, mesh4, M.MODEL_AXIS)
    x4 = rng.uniform(0, 1, (2, sp_h, sp_h, 3)).astype(np.float32)
    y4 = rng.integers(0, 4, (2, sp_h, sp_h))
    x4, y4 = sp.shard_batch_spatial((torch.from_numpy(x4), torch.from_numpy(y4)), mesh4,
                                    spatial_axis=M.MODEL_AXIS)
    loss4 = float(train_step(st4, loss_fn, x4, y4))
    _finite(loss4)
    _say(rank, f"dryrun_multichip({n}) sp{sp_n}: ok, loss={loss4:.4f}")

    # --- 5. GPipe over the ViT blocks in min(n, 4) stages ---
    pp_n, mesh5 = sp_n, mesh4
    vit5 = ClipViTConfig(image_size=32, patch_size=16, hidden_size=64, num_layers=pp_n,
                         num_heads=4, mlp_dim=128)
    vit_model = ClipViT(vit5)
    vit_model.init_weights(torch.Generator().manual_seed(5))
    pixels5 = torch.from_numpy(rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        _, hidden5 = vit_model(pixels5)
    stacked = {k: v.detach().clone().requires_grad_()
               for k, v in pp.stack_block_params(vit_model.state_dict(), pp_n).items()}
    local = pp.shard_stacked_params(stacked, mesh5)
    final, _ = pp.pipeline_blocks(pp.block_fn_for(TransformerBlock(vit5, False)), local,
                                  hidden5[0], mesh5, num_microbatches=2)
    loss5 = (final ** 2).mean()
    loss5.backward()
    sq = sum(float((g.grad ** 2).sum()) for g in stacked.values())
    sq = M.all_reduce_sum(torch.tensor([sq], dtype=torch.float64), mesh5.model_group)
    gnorm5 = float(sq.sqrt())
    _finite(float(loss5), gnorm5)
    _say(rank, f"dryrun_multichip({n}) pp{pp_n}: ok, loss={float(loss5):.4f}, "
               f"grad_norm={gnorm5:.4f}")

    # --- 6. the original-resolution eval, each process on its columns ---
    from image_segmentation_tpu_torch.data.dataset import ArrayDataset
    from image_segmentation_tpu_torch.data.loader import materialize
    from image_segmentation_tpu_torch.train.loop import evaluate

    rng6 = np.random.default_rng(6)
    items6 = []
    for i in range(2 * n + 3):  # a count that does not divide: a padded tail
        h, w = int(rng6.integers(24, 48)), int(rng6.integers(24, 48))
        img = rng6.uniform(0, 1, (h, w, 3)).astype(np.float32)
        lab = np.zeros((h, w), np.int32)
        lab[h // 2:, :] = 1 + (i % 3)
        items6.append((img, lab))
    val6 = materialize(ArrayDataset(items6), 32, keep_orig_labels=True)
    ref6 = evaluate(st3, val6, loss_cfg=loss_fn, protocol="device", batch_size=n,
                    verbose=False)
    out6 = evaluate(st3, val6, loss_cfg=loss_fn, protocol="device", batch_size=n,
                    verbose=False, axis=mesh)
    _finite(out6["loss"])
    if not (abs(ref6["loss"] - out6["loss"]) < 1e-6 and abs(ref6["iou"] - out6["iou"]) < 1e-9):
        raise AssertionError(f"sharded eval {out6} differs from one process's {ref6}")
    _say(rank, f"dryrun_multichip({n}) dp-sharded-eval: ok, loss={out6['loss']:.4f}, "
               f"miou={out6['iou']:.4f}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        rank, n, store = int(argv[1]), int(argv[2]), argv[3]
        from image_segmentation_tpu_torch.parallel.multihost import initialize_multihost

        torch.set_num_threads(1)
        initialize_multihost(store, n, rank, "cpu")
        worker(rank, n)
        torch.distributed.destroy_process_group()
        return 0
    n = int(argv[0]) if argv else 8
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{tmp}/store"
        procs = [subprocess.Popen([sys.executable, "-m", "image_segmentation_tpu_torch.parallel"
                                   ".dryrun", "--worker", str(r), str(n), store], env=env,
                                  stdout=None if r == 0 else subprocess.DEVNULL,
                                  stderr=subprocess.PIPE, text=True) for r in range(n)]
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        errs = []
        try:
            for p in procs:
                errs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[1])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    bad = [(r, p.returncode, e) for r, (p, e) in enumerate(zip(procs, errs)) if p.returncode]
    for r, rc, e in bad:
        print(f"dryrun_multichip({n}): process {r} exited {rc}:\n{e[-3000:]}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
