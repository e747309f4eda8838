"""`fit_multihost` in the other modes, and `run.py --multihost`.

- Online augmentation (`unet_aug`), the prompt model on prompt triplets,
  and the eval streamed past `ISTPU_EVAL_DEVICE_CACHE_MB`, each over 2
  CPU processes against the port's single-process `fit` on the same
  seed: train losses within JAX's tolerance for its two-process fit
  (tests/test_multihost.py:282-301) or twice the single-process fit's own
  spread under a 1e-6 relative perturbation of its init, whichever is
  wider; val metrics within 1e-2 (the same amplification, through eval
  argmax near-ties). On one state, the eval over the processes, per batch and
  resident, gives the single process's confusion bit for bit.
- `python -m image_segmentation_tpu_torch.run --multihost` as 2 processes
  runs to the end; each prints the backend first, process 0 alone prints
  the epoch lines; what the port refuses under `--multihost` (JAX's
  refusals), and `--platform` and `--max-devices`.

Children run as in tests/test_torch_multihost.py: a gloo group on a
`file://` store, a 120 s timeout and one torch thread each.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch import config as C
from image_segmentation_tpu_torch import run
from image_segmentation_tpu_torch.data.dataset import ArrayDataset
from image_segmentation_tpu_torch.data.labels import target_remap
from image_segmentation_tpu_torch.data.loader import materialize
from image_segmentation_tpu_torch.data.prompts import generate_prompt_dataset
from image_segmentation_tpu_torch.metrics import MetricsHistory
from image_segmentation_tpu_torch.ops.augment import random_augment_batch
from image_segmentation_tpu_torch.parallel.mesh import get_mesh
from image_segmentation_tpu_torch.parallel.multihost import initialize_multihost
from image_segmentation_tpu_torch.train import checkpoint as ckpt
from image_segmentation_tpu_torch.train import loop
from image_segmentation_tpu_torch.train.multihost_loop import fit_multihost
from image_segmentation_tpu_torch.train.state import TrainState, freeze_

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
SIDE = 32
FIT_KW = dict(epochs=2, batch_size=8, accum_steps=2, seed=3, verbose=False)
HISTORY = ("train_loss", "val_loss", "val_dice", "val_iou", "val_acc")
MODES = ("unet_aug", "prompt", "streamed_eval")


def _popen(argv, out_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=open(out_path, "w"),
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs, logs):
    """Wait for every child under one CHILD_TIMEOUT_S deadline; each must
    exit 0."""
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            texts.append(f.read())
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{texts[-1]}"
    return texts


# ---- the modes, through the API ------------------------------------------

def _items(n, seed, remap=True):
    # run.py's synthetic task at a quarter size
    return [(img[::4, ::4].copy(), target_remap(lab[::4, ::4]) if remap else lab[::4, ::4].copy())
            for img, lab in run._synthetic_items(n, seed)]


def _setup(mode: str, perturb: int = 0):
    """(state, train set, val set, fit keywords) of `mode`, from seeds; with
    `perturb`, every parameter times (1 + 1e-6·N(0, 1)) drawn from that
    seed."""
    if mode == "prompt":
        cfg = dataclasses.replace(C.PROMPT, target_size=SIDE)
        train = materialize(generate_prompt_dataset(ArrayDataset(_items(8, 0, False)), seed=0),
                            SIDE)
        val = materialize(generate_prompt_dataset(ArrayDataset(_items(4, 1, False)), seed=1),
                          SIDE, keep_orig_labels=True)
        frozen = ("clip.vision_model",)
    else:
        cfg = dataclasses.replace(C.UNET_AUG if mode == "unet_aug" else C.UNET_NOAUG,
                                  target_size=SIDE)
        train = materialize(ArrayDataset(_items(16, 0)), SIDE)
        # 16 val images: the eval also splits into canvas buckets
        val = materialize(ArrayDataset(_items(16 if mode == "streamed_eval" else 6, 1)), SIDE,
                          keep_orig_labels=True)
        frozen = ()
    overrides = run._smoke_vit_overrides(cfg) if mode == "prompt" else {"base": 8}
    model = C.build_model(cfg, "cpu", torch.Generator().manual_seed(0), **overrides)
    if perturb:
        noise = torch.Generator().manual_seed(perturb)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=noise))
    freeze_(model, frozen)
    state = TrainState(model, *C.build_optimizer(cfg, model, frozen_prefixes=frozen))
    kw = dict(FIT_KW, loss_fn=C.build_loss(cfg), eval_loss_cfg=C.build_val_loss(cfg),
              num_classes=cfg.num_classes, eval_ignore_index=cfg.eval_ignore_index,
              name=cfg.name, augment_fn=random_augment_batch if mode == "unet_aug" else None)
    return state, train, val, kw


def _eval_budget(mode):
    return "0.001" if mode == "streamed_eval" else None


def _eval(state, val, kw, axis=None) -> dict:
    agg = MetricsHistory(kw["num_classes"], ignore_index=kw["eval_ignore_index"])
    ev = loop.evaluate(state, val, loss_cfg=kw["eval_loss_cfg"], agg=agg, verbose=False,
                       axis=axis)
    return {"loss": ev["loss"], "confusion": agg.confusion.tolist(),
            "cached": [v.device_eval_cache is not None for v in (val.bucket_views or [val])]}


def w_mode(rank, world, mode, save_dir, out):
    """fit_multihost in `mode`; then the final state's eval over the
    processes (per batch and resident for the streamed mode)."""
    state, train, val, kw = _setup(mode)
    res = fit_multihost(state, train, val, save_dir=save_dir, **kw)
    result = {"history": ckpt._jsonable(res.history)}
    for name, budget in (("streamed", "0.001"), ("resident", None)):
        os.environ.pop(loop.EVAL_BUDGET_ENV, None)
        if budget:
            os.environ[loop.EVAL_BUDGET_ENV] = budget
        result[name] = _eval(res.state, val, kw, get_mesh("cpu"))
    torch.save(res.state.model.state_dict(), out + ".pt")
    with open(out, "w") as f:
        json.dump(result, f)


@pytest.mark.parametrize("mode", MODES)
def test_mode_over_two_processes_equals_single_process_fit(mode, tmp_path, monkeypatch):
    store = f"file://{tmp_path}/store"
    budget = _eval_budget(mode)
    logs = [str(tmp_path / f"log{r}") for r in range(2)]
    env_budget = {} if budget is None else {loop.EVAL_BUDGET_ENV: budget}
    with monkeypatch.context() as m:
        for k, v in env_budget.items():
            m.setenv(k, v)
        procs = [_popen([sys.executable, os.path.abspath(__file__), "w_mode", str(r), "2",
                         store, mode, str(tmp_path / "mh"), str(tmp_path / f"res{r}.json")],
                        logs[r]) for r in range(2)]
    if budget is not None:
        monkeypatch.setenv(loop.EVAL_BUDGET_ENV, budget)
    # the single-process fits run while the children do
    state, train, val, kw = _setup(mode)
    want = loop.fit(state, train, val, save_dir=str(tmp_path / "one"), **kw).history
    twins = []
    for seed in (7, 8):
        state, train, val, kw = _setup(mode, perturb=seed)
        twins.append(loop.fit(state, train, val, save_dir=str(tmp_path / f"twin{seed}"),
                              **kw).history)
    _wait(procs, logs)
    res = []
    for r in range(2):
        with open(tmp_path / f"res{r}.json") as f:
            res.append(json.load(f))
    got = res[0]["history"]
    for k in HISTORY:
        assert res[1]["history"][k] == got[k], k
    # the train losses: JAX's tolerance for its two-process fit against its
    # single-process one, or twice the single-process fit's own spread over
    # two draws of the perturbation where that is wider. The processes'
    # BatchNorm sums its statistics in another order than one process
    # does, and AdamW amplifies that rounding as it does the perturbation's
    w = np.asarray(want["train_loss"])
    spread = np.max([np.abs(np.subtract(t["train_loss"], w)) for t in twins], axis=0)
    assert np.all(np.abs(got["train_loss"] - w) <= np.maximum(2e-4 * w, 2 * spread)), (
        got["train_loss"], w, spread)
    # the val metrics of two epochs carry the same amplification into the
    # eval: AdamW moves each conv bias that feeds a train-mode BN ±lr on the
    # sign of rounding noise, the running means take part of it, and eval
    # argmax near-ties flip on these 16-image sets. The macro metrics are
    # held to 1e-2 (seen ≤ 7.8e-3; the perturbed single-process fits move
    # them up to 5.6e-3), the loss to 2e-3 (seen ≤ 7.9e-4). The eval path
    # itself is held bit for bit below
    for k in ("val_iou", "val_dice", "val_acc"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-2, err_msg=k)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], atol=2e-3)
    # the eval itself, on one state: the processes' columns give the
    # single process's confusion bit for bit, and its loss (the per-image
    # losses gathered back into the set's order)
    state, _, val, kw = _setup(mode)
    state.model.load_state_dict(torch.load(str(tmp_path / "res0.json") + ".pt"))
    one = _eval(state, val, kw)
    for r in res:
        for path in ("streamed", "resident"):
            assert r[path]["confusion"] == one["confusion"], (r, path)
            assert r[path]["loss"] == pytest.approx(one["loss"], rel=1e-6, abs=0), path
        # each took its own path
        assert not any(r["streamed"]["cached"]) and all(r["resident"]["cached"])


# ---- the CLI -------------------------------------------------------------

TINY = ["--config", "unet_noaug", "--synthetic", "16", "--epochs", "2", "--target-size", "32",
        "--batch-size", "4", "--device", "cpu"]


def test_cli_two_processes_run_to_the_end(tmp_path):
    save = str(tmp_path / "runs")
    logs = [str(tmp_path / f"log{r}") for r in range(2)]
    procs = [_popen([sys.executable, "-m", "image_segmentation_tpu_torch.run", *TINY,
                     "--save-dir", save, "--multihost", "--coordinator",
                     f"file://{tmp_path}/store", "--num-processes", "2", "--process-id", str(r),
                     "--tensorboard", str(tmp_path / "tb"), "--profile-dir",
                     str(tmp_path / "prof")], logs[r]) for r in range(2)]
    texts = _wait(procs, logs)
    for r, text in enumerate(texts):
        assert text.splitlines()[0] == f"[run] multihost: process {r}/2, backend gloo, device cpu"
    assert texts[0].count("Epoch ") == 2 and "[run] done" in texts[0]
    assert "Epoch " not in texts[1] and "[run] done" not in texts[1]
    with open(os.path.join(save, "metrics", "unet_noaug.json")) as f:
        history = json.load(f)
    for d in ("unet_noaug", "unet_noaug_last", "MO_unet_noaug"):
        assert os.path.isdir(os.path.join(save, d)), d
    # process 0's TensorBoard events and trace, and no one else's
    assert os.listdir(tmp_path / "tb" / "unet_noaug") and len(os.listdir(tmp_path / "prof")) == 1
    # the same run in one process: the same schedule (accumulation 4 of
    # micro 4, one step an epoch), JAX's train-loss tolerance
    one = run.main(TINY + ["--save-dir", str(tmp_path / "one")])
    np.testing.assert_allclose(history["train_loss"], one.history["train_loss"], rtol=2e-4)


@pytest.mark.parametrize("extra,message", [
    (["--multihost", "--evaluate", "x"], "--evaluate and recon configs are single-process"),
    (["--multihost", "--config", "recon_ae"], "--evaluate and recon configs are single-process"),
    (["--multihost", "--cache-features"], "not supported with --multihost: --cache-features"),
    (["--multihost", "--eval-protocol", "host"],
     "not supported with --multihost: --eval-protocol host"),
    (["--multihost"], "--multihost needs --coordinator"),
    (["--multihost", "--coordinator", "127.0.0.1:1"], "--coordinator needs --num-processes"),
    (["--max-devices", "2"], "a process of the port drives one device"),
    (["--platform", "tpu"], "pick the torch device with --device"),
    (["--platform", "gpu"], "--platform gpu and --device cpu disagree"),
])
def test_refused_under_multihost_and_platform(extra, message, monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit) as e:
        run.main(TINY + extra)
    assert isinstance(e.value.code, str) and message in e.value.code, e.value.code
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("platform,device,want", [
    ("cpu", None, "cpu"), ("gpu", None, "cuda"), ("cuda", "cuda:0", "cuda:0"), (None, None, "cuda"),
])
def test_platform_maps_onto_device(platform, device, want):
    args = run._parser().parse_args(["--config", "unet_noaug"]
                                    + (["--platform", platform] if platform else [])
                                    + (["--device", device] if device else []))
    assert run._device_arg(args) == want


if __name__ == "__main__":
    name, rank, world, store, *rest = sys.argv[1:]
    initialize_multihost(store, int(world), int(rank), "cpu")
    {"w_mode": w_mode}[name](int(rank), int(world), *rest)
    torch.distributed.destroy_process_group()
