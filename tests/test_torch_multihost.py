"""Data parallelism across processes held against the JAX package on the
whole batch: the losses' global sums (losses/), the global BatchNorm
(models/layers.py) and the data-parallel train step (train/steps.py),
plus the row and column blocks of parallel/multihost.py.

Each multi-process test starts 2 or 4 CPU processes of this file
(`python tests/test_torch_multihost.py WORKER RANK WORLD STORE OUT ...`)
in a gloo group on a `file://` store under the test's tmp_path, so no
TCP port is taken. A child imports torch and the port only, runs its
share and saves what it computed under OUT; the test compares that with
JAX on the whole batch in this process. Each child has a 120 s timeout
and one torch thread, so a collective that hangs fails its test alone.
"""
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.losses import DiceCELoss, DiceNLLLoss
from image_segmentation_tpu_torch.models.layers import BatchNorm
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.parallel import mesh
from image_segmentation_tpu_torch.parallel.mesh import DataAxis
from image_segmentation_tpu_torch.parallel.multihost import (
    assert_same_across_processes,
    initialize_multihost,
    process_local_batch_columns,
    process_local_indices,
)
from image_segmentation_tpu_torch.train.state import TrainState, make_adamw
from image_segmentation_tpu_torch.train.steps import local_step_rows, train_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120


def spawn(worker: str, world: int, tmp_path, *args) -> list:
    """Run `worker` in `world` processes of this file; each child's saved
    results, by rank. Every child must exit 0 within CHILD_TIMEOUT_S."""
    out = str(tmp_path)
    store = f"file://{tmp_path}/store"
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
    return [torch.load(os.path.join(out, f"{worker}.{r}.pt")) for r in range(world)]


def _axis(rank, world) -> DataAxis:
    return DataAxis(int(world), int(rank), torch.device("cpu"))


# ---- the losses' global sums --------------------------------------------

B_LOSS = 8
LOSS_KW = dict(class_weights=(0.5, 1.0, 1.5, 2.0), ignore_index=3, smooth_dice=1.0)


def _loss_inputs(kind: str):
    """Logits and targets whose halves differ, as images of a batch do: the
    first half's pixels are classes 0-1, the second's 1-3."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 2, (B_LOSS, 16, 16, 4)).astype(np.float32)
    if kind == "dice_nll":  # the prompt model emits probabilities
        x = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    half = B_LOSS // 2
    t = np.concatenate([rng.integers(0, 2, (half, 16, 16)),
                        rng.integers(1, 4, (B_LOSS - half, 16, 16))])
    return x, t.astype(np.int64)


def _port_loss(kind: str):
    return DiceCELoss(**LOSS_KW) if kind == "dice_ce" else DiceNLLLoss(**LOSS_KW)


def w_loss(rank, world, kind):
    """This rank's shard through the loss in the group: the global loss
    and its gradient; and the shard's loss alone (no group sums)."""
    x, t = _loss_inputs(kind)
    rows = process_local_indices(B_LOSS, _axis(rank, world))
    xs = torch.from_numpy(x[rows]).requires_grad_()
    loss = _port_loss(kind)(xs, torch.from_numpy(t[rows]))
    loss.backward()
    with mock.patch.object(mesh, "world_size", lambda: 1):
        alone = _port_loss(kind)(torch.from_numpy(x[rows]), torch.from_numpy(t[rows]))
    return {"loss": loss.detach(), "grad": xs.grad, "alone": alone}


@pytest.mark.parametrize("kind", ["dice_ce", "dice_nll"])
def test_global_loss_over_two_processes_is_jax_loss_on_the_whole_batch(kind, tmp_path):
    import jax
    import jax.numpy as jnp

    from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
    from image_segmentation_tpu.losses import DiceNLLLoss as JaxDiceNLL

    res = spawn("w_loss", 2, tmp_path, kind)
    x, t = _loss_inputs(kind)
    jfn = (JaxDiceCE if kind == "dice_ce" else JaxDiceNLL)(**LOSS_KW)
    want, jgrad = jax.value_and_grad(lambda a: jfn(a, jnp.asarray(t)))(jnp.asarray(x))
    want, jgrad = float(want), np.asarray(jgrad)
    # every process holds the global loss: f32 sums in another order
    # (seen ≤ 2e-7 relative)
    tol = 1e-5
    for r in res:
        np.testing.assert_allclose(float(r["loss"]), want, rtol=tol)
    # each backward differentiates W·L (parallel/mesh.py): a shard's
    # gradient over W is JAX's on those rows. Relative L2 ≤ 1e-5
    grad = torch.cat([r["grad"] for r in res]).numpy() / len(res)
    assert np.linalg.norm(grad - jgrad) <= tol * np.linalg.norm(jgrad)
    # what DDP over per-process losses would train on misses by ≥ 100×
    shard_mean = np.mean([float(r["alone"]) for r in res])
    assert abs(shard_mean - want) >= 100 * tol * abs(want), (shard_mean, want)


# ---- the global BatchNorm ------------------------------------------------

B_BN, C_BN = 8, 3


def _bn_inputs():
    rng = np.random.default_rng(6)
    x = rng.normal(1.5, 2.0, (B_BN, C_BN, 6, 5)).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    params = {k: rng.normal(0, 1, C_BN).astype(np.float32) for k in ("weight", "bias")}
    stats = {"running_mean": rng.normal(0, 1, C_BN).astype(np.float32),
             "running_var": rng.uniform(0.5, 2, C_BN).astype(np.float32)}
    return x, g, params, stats


def w_bn(rank, world):
    """Train-mode BN on this rank's rows; backward of Σ g·y."""
    x, g, params, stats = _bn_inputs()
    rows = process_local_indices(B_BN, _axis(rank, world))
    bn = BatchNorm(C_BN)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in {**params, **stats}.items()})
    bn.train()
    xs = torch.from_numpy(x[rows]).requires_grad_()
    y = bn(xs)
    (y * torch.from_numpy(g[rows])).sum().backward()
    return {"y": y.detach(), "dx": xs.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def test_global_batchnorm_is_flax_batchnorm_on_the_whole_batch(tmp_path):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    res = spawn("w_bn", 2, tmp_path)
    x, g, params, stats = _bn_inputs()
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))  # NHWC, as flax takes it
    variables = {"params": {"scale": params["weight"], "bias": params["bias"]},
                 "batch_stats": {"mean": stats["running_mean"], "var": stats["running_var"]}}

    def f(xin, p):
        y, mut = bn.apply({"params": p, "batch_stats": variables["batch_stats"]}, xin,
                          mutable=["batch_stats"])
        return (y * jnp.asarray(g.transpose(0, 2, 3, 1))).sum(), (y, mut)

    (_, (y, mut)), (dx, dp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        xh, variables["params"])
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    # forward and input gradient: f32, flax's E[x²] − E[x]² against the
    # two-pass variance (seen ≤ 1e-6 absolute)
    np.testing.assert_allclose(torch.cat([r["y"] for r in res]).numpy(), nchw(y), atol=1e-5)
    np.testing.assert_allclose(torch.cat([r["dx"] for r in res]).numpy(), nchw(dx), atol=1e-5)
    # each process's parameter gradient is its rows' part; their sum is flax's
    np.testing.assert_allclose(sum(r["dweight"] for r in res).numpy(), dp["scale"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sum(r["dbias"] for r in res).numpy(), dp["bias"], rtol=1e-5,
                               atol=1e-5)
    # the running statistics (biased variance) are the same on every process
    for r in res:
        np.testing.assert_allclose(r["running_mean"].numpy(), mut["batch_stats"]["mean"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["running_var"].numpy(), mut["batch_stats"]["var"],
                                   rtol=1e-6, atol=1e-6)


# ---- the data-parallel train step ----------------------------------------

BASE, SIDE, MICRO, ACCUM, STEPS, LR, WD = 8, 64, 4, 2, 2, 1e-3, 0.01
STEP_LOSS_KW = dict(class_weights=(1.0, 1.0, 1.0, 1.0), smooth_dice=1.0)


def _step_batches():
    rng = np.random.default_rng(7)
    b = MICRO * ACCUM
    return [(rng.uniform(0, 1, (b, SIDE, SIDE, 3)).astype(np.float32),
             rng.integers(0, 4, (b, SIDE, SIDE)).astype(np.int64)) for _ in range(STEPS)]


def _port_state(init_path: str) -> TrainState:
    model = UNet(base=BASE)
    model.load_state_dict(torch.load(init_path))
    model = model.to(memory_format=torch.channels_last)
    return TrainState(model, *make_adamw(model.parameters(), learning_rate=LR,
                                         weight_decay=WD))


def w_step(rank, world, init_path):
    """STEPS data-parallel steps from the carried-over JAX init."""
    st = _port_state(init_path)
    rows = local_step_rows(MICRO * ACCUM, ACCUM, _axis(rank, world))
    losses = [train_step(st, DiceCELoss(**STEP_LOSS_KW), torch.from_numpy(x[rows]),
                         torch.from_numpy(y[rows]), ACCUM) for x, y in _step_batches()]
    return {"losses": torch.stack(losses), "state": st.model.state_dict()}


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """The JAX init (its BN statistics moved off 0/1 by one train apply),
    saved as the port's state_dict, and JAX's STEPS steps on the whole
    step batches."""
    import jax
    import jax.numpy as jnp

    from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
    from image_segmentation_tpu.models import UNet as JaxUNet
    from image_segmentation_tpu.train import create_train_state, make_train_step
    from image_segmentation_tpu.train.state import make_adamw as jax_adamw
    from image_segmentation_tpu_torch.models.convert import from_jax_variables

    model = JaxUNet(num_classes=4, base=BASE)
    x0 = jnp.asarray(np.random.default_rng(8).uniform(0, 1, (2, SIDE, SIDE, 3)), jnp.float32)
    v = model.init(jax.random.PRNGKey(0), x0, train=False)
    _, mut = model.apply(v, x0, train=True, mutable=["batch_stats"])
    variables = {"params": v["params"], "batch_stats": mut["batch_stats"]}
    path = str(tmp_path_factory.mktemp("init") / "init.pt")
    torch.save(from_jax_variables(jax.tree_util.tree_map(np.asarray, variables)), path)
    tx = jax_adamw(learning_rate=LR, weight_decay=WD)
    st = create_train_state(model, jax.random.PRNGKey(0), x0[:1], tx)
    st = st.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"]))
    step = make_train_step(JaxDiceCE(**STEP_LOSS_KW), accum_steps=ACCUM)
    losses = []
    for x, y in _step_batches():
        st, loss = step(st, (jnp.asarray(x), jnp.asarray(y.astype(np.int32))))
        losses.append(float(loss))
    want = {k: t.numpy() for k, t in from_jax_variables(jax.tree_util.tree_map(
        np.asarray, {"params": st.params, "batch_stats": st.batch_stats})).items()}
    return path, np.asarray(losses), want


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_is_jax_step_on_the_whole_batch(world, jax_steps, tmp_path):
    init_path, jax_losses, want = jax_steps
    res = spawn("w_step", world, tmp_path, init_path)
    init = torch.load(init_path)
    for r in res:
        # the global micro-batch losses, averaged: f32 sums in another order
        # (seen ≤ 1e-7 relative at both steps)
        np.testing.assert_allclose(r["losses"].numpy(), jax_losses, rtol=1e-5)
    # every process holds the same state
    for k, t in res[0]["state"].items():
        for r in res[1:]:
            assert torch.equal(r["state"][k], t), k
    for k, t in res[0]["state"].items():
        got = t.numpy()
        if "running" in k:
            # a running mean holds its conv's bias, which AdamW moves ±lr a
            # step on the sign of rounding noise (below): lr for the means
            # (seen ≤ 3.2e-4), 1e-4 for the variances (seen ≤ 1.5e-5)
            bound = LR if k.endswith("running_mean") else 1e-4
            assert np.abs(got - want[k]).max() <= bound, (k, np.abs(got - want[k]).max())
            continue
        # no element farther than AdamW's ±lr a step apart
        assert np.abs(got - want[k]).max() <= 2 * STEPS * LR, k
        if k.endswith(("conv1.conv.bias", "conv2.conv.bias")):
            # a conv bias that feeds a train-mode BN has gradient 0 in exact
            # arithmetic: its steps follow the sign of rounding noise
            continue
        # the two steps' update against JAX's, relative L2: ≤ 0.15 (seen ≤
        # 0.094). Adam's second step divides by the root of a squared-
        # gradient estimate, which amplifies f32 reassociation of small
        # gradients; the port's single-process step lands 0.03-0.23 from
        # JAX by this measure, with its closed-form BN backward
        up, jup = got - init[k].numpy(), want[k] - init[k].numpy()
        assert np.linalg.norm(up - jup) <= 0.15 * np.linalg.norm(jup), (
            k, np.linalg.norm(up - jup) / np.linalg.norm(jup))


# ---- rows and columns ----------------------------------------------------

def test_local_step_rows_partition_each_micro_batch():
    for world in (1, 2, 4):
        parts = [local_step_rows(16, 2, _axis(r, world)) for r in range(world)]
        assert sorted(np.concatenate(parts).tolist()) == list(range(16))
        for r, rows in enumerate(parts):
            # the rank's contiguous 1/W of micro-batch 0, then of micro-batch 1
            k = 8 // world
            assert rows.tolist() == [*range(r * k, (r + 1) * k),
                                     *range(8 + r * k, 8 + (r + 1) * k)]
    with pytest.raises(ValueError, match="micro-batch of 6 rows does not divide over 4"):
        local_step_rows(12, 2, _axis(0, 4))


def test_process_local_blocks_and_jax_divisibility_message():
    assert process_local_indices(8, _axis(1, 4)).tolist() == [2, 3]
    assert process_local_batch_columns(8, _axis(3, 4)).tolist() == [6, 7]
    with pytest.raises(ValueError, match=r"length 6 does not divide the data axis \(4 shards\)"):
        process_local_indices(6, _axis(0, 4))


def w_tripwire(rank, world):
    """The divergence tripwire passes a value every process holds, and
    raises on every process for one that differs."""
    axis = _axis(rank, world)
    assert_same_across_processes(1.5, axis)
    try:
        assert_same_across_processes(float(rank), axis, name="rank")
    except AssertionError as e:
        return {"raised": str(e)}
    return {"raised": ""}


def test_divergence_tripwire_raises_on_every_process(tmp_path):
    for r in spawn("w_tripwire", 2, tmp_path):
        assert r["raised"] == "rank diverged across processes: [0.0, 1.0]"


WORKERS = {"w_loss": w_loss, "w_bn": w_bn, "w_step": w_step, "w_tripwire": w_tripwire}

if __name__ == "__main__":
    name, rank, world, store, out, *rest = sys.argv[1:]
    initialize_multihost(store, int(world), int(rank), "cpu")
    result = WORKERS[name](int(rank), int(world), *rest)
    torch.save(result, os.path.join(out, f"{name}.{rank}.pt"))
    torch.distributed.destroy_process_group()
