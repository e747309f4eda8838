"""`fit_multihost` across 2 and 4 CPU processes held against JAX's
single-process `fit`, and its checkpoints, resume and early stop.

- Two epochs over 2 and over 4 processes from one JAX init (carried over by
  `models.convert.from_jax_variables`), the same materialised data and
  the same shuffle seed as JAX's single-process `fit`: the per-epoch
  history within JAX's own tolerances for its two-process fit
  (tests/test_multihost.py:282-301). Process 0 alone writes the
  checkpoints and the metrics file.
- A run of 1 epoch resumed for a second over 2 processes equals the
  port's single-process run resumed the same way.
- `early_stop_patience` stops every process at the same epoch. JAX's
  `fit_multihost` takes no such argument, and its run.py:664 passes none,
  so `--early-stop-patience` is dropped under JAX's `--multihost`.

The processes are children of this file in a gloo group on a `file://`
store (tests/test_torch_multihost.py describes the harness); each has a
120 s timeout and one torch thread.
"""
import inspect
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.data.dataset import ArrayDataset
from image_segmentation_tpu_torch.data.labels import target_remap
from image_segmentation_tpu_torch.data.loader import materialize
from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.ops import geometry as port_geometry
from image_segmentation_tpu_torch.parallel.multihost import initialize_multihost
from image_segmentation_tpu_torch.run import _synthetic_items
from image_segmentation_tpu_torch.train import checkpoint as ckpt
from image_segmentation_tpu_torch.train import loop
from image_segmentation_tpu_torch.train.loop import fit
from image_segmentation_tpu_torch.train.multihost_loop import fit_multihost
from image_segmentation_tpu_torch.train.state import TrainState, make_adamw

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
SIDE, BASE, LR, WD = 32, 8, 1e-3, 0.01
# the unet_noaug recipe: FullWeight, no ignore index, train smooth 1
LOSS_KW = dict(class_weights=(1.0, 1.0, 1.0, 1.0), smooth_dice=1.0)
FIT_KW = dict(epochs=2, batch_size=8, accum_steps=2, name="mh", seed=3, verbose=False)
HISTORY = ("train_loss", "val_loss", "val_dice", "val_iou", "val_acc")


def spawn(worker: str, world: int, tmp_path, *args) -> list:
    """`worker` in `world` processes of this file; each child's results."""
    out = str(tmp_path)
    store = f"file://{tmp_path}/store.{worker}.{time.monotonic_ns()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), worker, str(r),
                               str(world), store, out, *map(str, args)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {worker} exited {p.returncode}:\n{log}"
    results = []
    for r in range(world):
        with open(os.path.join(out, f"{worker}.{r}.json")) as f:
            results.append(json.load(f))
    return results


def _items(n, seed):
    # run.py's synthetic task at a quarter size, the boundary remapped
    return [(img[::4, ::4].copy(), target_remap(lab[::4, ::4]))
            for img, lab in _synthetic_items(n, seed)]


def _port_data():
    """16 train and 6 val items on the numpy resampler, which both
    packages share bit for bit (tests/test_torch_loader.py)."""
    with mock.patch.object(port_geometry, "_native", lambda: None):
        return (materialize(ArrayDataset(_items(16, 0)), SIDE),
                materialize(ArrayDataset(_items(6, 1)), SIDE, keep_orig_labels=True))


def _port_state(init_path) -> TrainState:
    model = UNet(base=BASE)
    model.load_state_dict(torch.load(init_path))
    model = model.to(memory_format=torch.channels_last)
    return TrainState(model, *make_adamw(model.parameters(), learning_rate=LR,
                                         weight_decay=WD))


def _jsonable(res) -> dict:
    return {"history": ckpt._jsonable(res.history), "best": res.best}


def w_fit(rank, world, init_path, save_dir, opts):
    """fit_multihost on this process's share, counting the files it writes;
    `opts` (JSON) overrides FIT_KW."""
    opts = json.loads(opts)
    writes = []
    def counted(fn, what=None):
        return lambda path, *a: (writes.append(what or path), fn(path, *a))

    with mock.patch.object(ckpt, "_write", counted(ckpt._write)), \
            mock.patch.object(ckpt, "save_params_only", counted(ckpt.save_params_only)), \
            mock.patch.object(loop, "_save_history", counted(loop._save_history, "history")):
        if opts.pop("frozen_metrics", False):
            _freeze_metrics()
        train, val = _port_data()
        res = fit_multihost(_port_state(init_path), train, val, loss_fn=DiceCELoss(**LOSS_KW),
                            save_dir=save_dir, **{**FIT_KW, **opts})
    return {**_jsonable(res), "writes": writes}


def _freeze_metrics():
    """Every epoch's eval runs (its collectives included) but reports the
    first epoch's metrics, so no epoch after the first improves."""
    real, first = loop.evaluate, []

    def evaluate(*a, **kw):
        out = real(*a, **kw)
        first.append(first[0] if first else out)
        return first[-1]

    loop.evaluate = evaluate


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """A JAX UNet init, saved as the port's state_dict."""
    import jax
    import jax.numpy as jnp

    from image_segmentation_tpu.models import UNet as JaxUNet
    from image_segmentation_tpu_torch.models.convert import from_jax_variables

    v = JaxUNet(num_classes=4, base=BASE, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)))
    path = str(tmp_path_factory.mktemp("init") / "init.pt")
    torch.save(from_jax_variables(jax.tree_util.tree_map(np.asarray, dict(v))), path)
    return path


@pytest.mark.parametrize("world", [2, 4])
def test_fit_multihost_is_jax_single_process_fit(world, jax_init, tmp_path):
    import jax
    import jax.numpy as jnp

    from image_segmentation_tpu.data.dataset import ArrayDataset as JaxArrayDataset
    from image_segmentation_tpu.data.loader import materialize as jax_materialize
    from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
    from image_segmentation_tpu.models import UNet as JaxUNet
    from image_segmentation_tpu.ops import geometry as jax_geometry
    from image_segmentation_tpu.train import create_train_state
    from image_segmentation_tpu.train import loop as jax_loop
    from image_segmentation_tpu.train.state import make_adamw as jax_adamw

    save = str(tmp_path / "run")
    res = spawn("w_fit", world, tmp_path, jax_init, save, "{}")
    with mock.patch.object(jax_geometry, "_native", lambda: None):
        jtrain = jax_materialize(JaxArrayDataset(_items(16, 0)), SIDE)
        jval = jax_materialize(JaxArrayDataset(_items(6, 1)), SIDE, keep_orig_labels=True)
    # a fresh state per fit: JAX's fit donates it
    state = lambda: create_train_state(  # noqa: E731
        JaxUNet(num_classes=4, base=BASE, dtype=jnp.float32), jax.random.PRNGKey(0),
        jnp.zeros((1, SIDE, SIDE, 3)), jax_adamw(learning_rate=LR, weight_decay=WD))
    jfit = lambda st, d: jax_loop.fit(st, jtrain, jval, loss_fn=JaxDiceCE(**LOSS_KW),  # noqa
                                      save_dir=str(tmp_path / d), **FIT_KW)
    want = jfit(state(), "jax")
    # JAX against itself from an init perturbed by 1e-6 relative: how far
    # two epochs of AdamW carry f32 rounding in the val metrics here
    noise = np.random.default_rng(7)
    st = state()
    twin = jfit(st.replace(params=jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-6 * noise.standard_normal(a.shape)).astype(np.float32),
        st.params)), "jax_twin").history
    got = res[0]["history"]
    # every process holds the same history (but its own clock)
    for r in res[1:]:
        for k in HISTORY + ("val_per_class_iou",):
            assert r["history"][k] == got[k], k
        assert r["best"] == res[0]["best"]
    # the train losses within JAX's tolerance for its own two-process fit
    # against its single-process one (tests/test_multihost.py:282-301;
    # seen ≤ 2.3e-5 relative)
    np.testing.assert_allclose(got["train_loss"], want.history["train_loss"], rtol=2e-4)
    # the val metrics within JAX's tolerances there, or within twice JAX's
    # own spread where that is wider. AdamW moves each conv bias that feeds
    # a train-mode BN ±lr a step on the sign of rounding noise, the running
    # means take part of it, and eval argmax near-ties flip: JAX's spread
    # reaches 7e-3 in val mIoU after epoch 1 (the port: ≤ 4.2e-3)
    for k, rtol, atol in (("val_loss", 1e-3, 1e-6), ("val_iou", 2e-3, 2e-3),
                          ("val_dice", 2e-3, 2e-3), ("val_acc", 2e-3, 2e-3)):
        w, spread = np.asarray(want.history[k]), np.abs(np.subtract(twin[k], want.history[k]))
        bound = np.maximum(atol + rtol * np.abs(w), 2 * spread)
        assert np.all(np.abs(np.subtract(got[k], w)) <= bound), (k, got[k], w, bound)
    # process 0 alone wrote: the metrics file each epoch, and each best
    # epoch's `mh`, `mh_last` and `MO_mh`
    assert all(r["writes"] == [] for r in res[1:])
    assert res[0]["writes"].count("history") == 2
    for d in ("mh", "mh_last", "MO_mh"):
        assert os.path.join(save, d) in res[0]["writes"], d
        assert os.path.isdir(os.path.join(save, d)), d
    with open(os.path.join(save, "metrics", "mh.json")) as f:
        assert json.load(f)["train_loss"] == got["train_loss"]


def test_resume_over_two_processes_equals_single_process_resume(jax_init, tmp_path):
    """1 epoch, then a resume for a second, over 2 processes: the same
    history as 2 epochs at once over 2 processes, bit for bit, and as the
    port's single-process resume (the shuffle replayed to epoch 2) within
    JAX's train-loss tolerance."""
    full = spawn("w_fit", 2, tmp_path, jax_init, str(tmp_path / "full"), "{}")
    save = str(tmp_path / "mh")
    spawn("w_fit", 2, tmp_path, jax_init, save, json.dumps({"epochs": 1}))
    res = spawn("w_fit", 2, tmp_path, jax_init, save, json.dumps({"resume": True}))
    for r in res:
        for k in HISTORY:
            assert r["history"][k] == full[0]["history"][k], k
    assert res[0]["best"] == full[0]["best"] and res[1]["writes"] == []
    train, val = _port_data()
    kw = dict(FIT_KW, loss_fn=DiceCELoss(**LOSS_KW))
    fit(_port_state(jax_init), train, val, save_dir=str(tmp_path / "one"),
        **dict(kw, epochs=1))
    want = fit(_port_state(jax_init), train, val, save_dir=str(tmp_path / "one"), resume=True,
               **kw)
    np.testing.assert_allclose(res[0]["history"]["train_loss"], want.history["train_loss"],
                               rtol=2e-4)


def test_early_stop_is_honoured_under_multihost_unlike_jax(jax_init, tmp_path):
    from image_segmentation_tpu.train import multihost_loop as jax_multihost_loop

    res = spawn("w_fit", 2, tmp_path, jax_init, str(tmp_path / "mh"), json.dumps(
        {"epochs": 5, "early_stop_patience": 1, "frozen_metrics": True}))
    for r in res:
        assert r["history"]["stopped_early"] == [2]
        assert len(r["history"]["train_loss"]) == 2
    with open(tmp_path / "mh" / "metrics" / "mh.json") as f:
        assert json.load(f)["stopped_early"] == [2]
    # JAX drops the flag: its fit_multihost has no such argument, and its
    # run.py's multihost call passes none
    assert "early_stop_patience" not in inspect.signature(
        jax_multihost_loop.fit_multihost).parameters
    with open(os.path.join(ROOT, "image_segmentation_tpu", "run.py")) as f:
        src = f.read()
    call = src[src.index("result = fit_multihost("):]
    assert "early_stop_patience" not in call[:call.index(")\n")]


WORKERS = {"w_fit": w_fit}

if __name__ == "__main__":
    name, rank, world, store, out, *rest = sys.argv[1:]
    initialize_multihost(store, int(world), int(rank), "cpu")
    result = WORKERS[name](int(rank), int(world), *rest)
    with open(os.path.join(out, f"{name}.{rank}.json"), "w") as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()
