"""Spatial partitioning (parallel/sp.py) held against the JAX package on one
device: the UNet forward through the module path and through the plain
K1 on haloed slabs (models/fused_unet.py), and one SGD train step, pure SP
and DP × SP, each pinned to JAX's single-device result as JAX's
test_sp.py pins its own; plus the spec rules, the guard and its
envelope, the port's ragged-shard refusal and the halo's row arithmetic.

The multi-process checks run in one group of 4 CPU processes of this
file (tests/torch_spawn.py).
"""
import os

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.parallel import mesh as M
from image_segmentation_tpu_torch.parallel import sp
from image_segmentation_tpu_torch.train.state import TrainState
from image_segmentation_tpu_torch.train.steps import train_step

torch.set_num_threads(1)

SIDE = 64  # 4 shards leave the bottleneck (4 rows) one row a shard
LR = 0.1


def _data():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, SIDE, SIDE, 3)).astype(np.float32)
    y = rng.integers(0, 4, (2, SIDE, SIDE))
    rng = np.random.default_rng(2)
    x2 = rng.uniform(0, 1, (4, SIDE, SIDE, 3)).astype(np.float32)
    y2 = rng.integers(0, 4, (4, SIDE, SIDE))
    return x, y, x2, y2


def _port_unet(init_path):
    net = UNet(num_classes=4, base=8)
    net.load_state_dict(torch.load(init_path))
    return net.to(memory_format=torch.channels_last)


def _step(net, x, y):
    st = TrainState(net, torch.optim.SGD(net.parameters(), lr=LR))
    loss = train_step(st, DiceCELoss(ignore_index=None), x, y)
    return float(loss), {k: v.clone() for k, v in net.state_dict().items()}


def w_sp(rank, world, init_path):
    """4 ranks: pure SP forwards and step, a halo check at one row a shard,
    then DP x SP (2 x 2) step."""
    from image_segmentation_tpu_torch.ops.kernels.blocks import haloed
    from image_segmentation_tpu_torch.ops.kernels.double_conv import double_conv_reference

    x, y, x2, y2 = (torch.from_numpy(a) for a in _data())
    out = {}
    mesh = M.get_mesh("cpu")
    net = sp.partition_model(_port_unet(init_path), mesh)
    xs, ys = sp.shard_batch_spatial((x, y), mesh)
    net.eval()
    with torch.no_grad():
        out["module"] = net(xs)
        net.use_kernels = True  # the K1 path, through its plain version on the CPU
        out["fused"] = net(xs)
    net.use_kernels = False
    out["loss"], out["state"] = _step(net, xs, ys)
    # K1 on haloed slabs of one row a shard: rows come from past the neighbour
    g = torch.Generator().manual_seed(3)
    z = torch.randn(2, world, 5, 6, generator=g)
    args = (torch.randn(3, 3, 6, 4, generator=g), 1 + 0.1 * torch.randn(4, generator=g),
            0.1 * torch.randn(4, generator=g), torch.randn(3, 3, 4, 4, generator=g),
            1 + 0.1 * torch.randn(4, generator=g), 0.1 * torch.randn(4, generator=g))
    axis = sp.spatial_axis_of(mesh)
    out["halo"] = haloed(double_conv_reference, [z[:, rank:rank + 1].contiguous()], args, axis)
    out["halo_want"] = double_conv_reference(z, *args)[:, rank:rank + 1]
    # DP x SP: the batch on 'data' (2), H on 'model' (2)
    mesh2 = M.get_mesh("cpu", model_parallel=2)
    net2 = sp.partition_model(_port_unet(init_path), mesh2, M.MODEL_AXIS)
    xs2, ys2 = sp.shard_batch_spatial((x2, y2), mesh2, spatial_axis=M.MODEL_AXIS,
                                      batch_axis=M.DATA_AXIS)
    out["loss2"], out["state2"] = _step(net2, xs2, ys2)
    return out


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """JAX's init (as the port's state dict), its forward of the pure-SP
    batch, and its single-device SGD step on each batch."""
    import jax
    import jax.numpy as jnp
    import optax

    from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
    from image_segmentation_tpu.models import UNet as JaxUNet
    from image_segmentation_tpu.train import create_train_state
    from image_segmentation_tpu.train.steps import make_train_step
    from image_segmentation_tpu_torch.models.convert import from_jax_variables

    model = JaxUNet(num_classes=4, base=8)
    x, y, x2, y2 = _data()
    fresh = lambda: create_train_state(  # noqa: E731
        model, jax.random.PRNGKey(0), jnp.zeros((1, SIDE, SIDE, 3)), optax.sgd(LR))
    st = fresh()
    variables = {"params": st.params, "batch_stats": st.batch_stats}
    to_port = lambda v: from_jax_variables(jax.tree_util.tree_map(np.asarray, v))  # noqa: E731
    path = str(tmp_path_factory.mktemp("sp") / "init.pt")
    torch.save(to_port(variables), path)
    forward = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    step = make_train_step(JaxDiceCE(ignore_index=None))
    steps = []
    for xb, yb in ((x, y), (x2, y2)):
        s, loss = step(fresh(), (jnp.asarray(xb), jnp.asarray(yb.astype(np.int32))))
        steps.append((float(loss), {k: v.numpy() for k, v in to_port(
            {"params": s.params, "batch_stats": s.batch_stats}).items()}))
    return path, forward, steps


@pytest.fixture(scope="module")
def sp_run(jax_refs, tmp_path_factory):
    return spawn(os.path.abspath(__file__), "w_sp", 4, tmp_path_factory.mktemp("sp_run"),
                 jax_refs[0])


def _assert_state(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=5e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("path", ["module", "fused"])
def test_sp_forward_is_jax_forward(path, jax_refs, sp_run):
    """Pure SP over 4 shards (16 rows each, one bottleneck row): the rows put
    back in order are JAX's single-device forward (test_sp.py:67, atol 2e-5)."""
    got = torch.cat([r[path] for r in sp_run], dim=1).numpy()
    np.testing.assert_allclose(got, jax_refs[1], atol=2e-5)


def test_k1_on_haloed_slabs_reaches_past_the_neighbour(sp_run):
    """One row a shard: the asymmetric 2-row halo takes rows from two shards
    away, and the crop is exact (the plain K1 on the whole image)."""
    for r in sp_run:
        np.testing.assert_allclose(r["halo"].numpy(), r["halo_want"].numpy(), atol=1e-5)


@pytest.mark.parametrize("layout", ["pure_sp", "dp_x_sp"])
def test_sp_train_step_is_jax_step(layout, jax_refs, sp_run):
    """One SGD step (linear in the gradient): the loss, the parameters and
    the BN statistics of every rank are JAX's single-device step's
    (test_sp.py:125-174: loss 1e-5, atol 5e-5, rtol 1e-4)."""
    key = "" if layout == "pure_sp" else "2"
    want_loss, want = jax_refs[2][0 if layout == "pure_sp" else 1]
    for r in sp_run:
        assert abs(r["loss" + key] - want_loss) < 1e-5
        _assert_state(r["state" + key], want)


def test_spec_rules():
    assert sp.spatial_spec(4) == (None, M.DATA_AXIS)
    assert sp.spatial_spec(3) == (None, M.DATA_AXIS)
    assert sp.spatial_spec(4, M.MODEL_AXIS, M.DATA_AXIS) == (M.DATA_AXIS, M.MODEL_AXIS)
    assert sp.spatial_spec(1) == (None,)
    assert sp.spatial_spec(0) == ()


def _mesh(n):
    return M.Mesh(n, 0, torch.device("cpu"))


def test_guard_rejects_sub_bottleneck_sharding_with_jax_message():
    """8 shards of H = 64 leave the bottleneck (4 rows) fewer rows than
    shards: refused with JAX's own message; a conv-only factor passes."""
    import jax
    import jax.numpy as jnp

    from image_segmentation_tpu.parallel.mesh import get_mesh as jax_mesh
    from image_segmentation_tpu.parallel.sp import shard_batch_spatial as jax_shard

    with pytest.raises(ValueError) as want:
        jax_shard(jnp.zeros((2, 64, 64, 3)), jax_mesh(jax.devices()[:8]))
    with pytest.raises(ValueError) as got:
        sp.shard_batch_spatial(torch.zeros(2, 64, 64, 3), _mesh(8))
    assert str(got.value) == str(want.value)
    assert sp.shard_batch_spatial(torch.zeros(2, 64, 64, 3), _mesh(8),
                                  downsample_factor=1).shape == (2, 8, 64, 3)


def test_max_spatial_shards_envelope():
    assert sp.max_spatial_shards(128) == 8
    assert sp.max_spatial_shards(256) == 16
    assert sp.max_spatial_shards(2048) == 128
    assert sp.max_spatial_shards(64) == 4
    assert sp.max_spatial_shards(8) == 1
    assert sp.max_spatial_shards(64, downsample_factor=1) == 64
    # the envelope's boundary passes the guard
    assert sp.shard_batch_spatial(torch.zeros(1, 128, 128, 3), _mesh(8)).shape[1] == 16


def test_ragged_shards_are_refused_naming_both_numbers():
    """XLA pads a ragged shard; the port refuses it (a divergence)."""
    with pytest.raises(ValueError, match=r"shards of 24 rows, not a multiple of the "
                                         r"downsample factor 16"):
        sp.shard_batch_spatial(torch.zeros(1, 48, 48, 3), _mesh(2))
    net = UNet(base=8).eval()
    net.spatial = sp.SpatialAxis(None, 2, 0)
    with pytest.raises(ValueError, match="a shard of 24 rows is not a multiple"):
        net(torch.zeros(1, 24, 48, 3))


def test_sp_covers_the_unet_only():
    from image_segmentation_tpu_torch.models.autoencoder import SegmentationAutoencoder

    with pytest.raises(TypeError, match="covers the UNet.*got SegmentationAutoencoder"):
        sp.partition_model(SegmentationAutoencoder(), _mesh(2))


@pytest.mark.parametrize("index,want", [(0, (0, 2)), (1, (1, 2)), (2, (2, 1)), (3, (2, 0))])
def test_halo_rows_at_one_row_a_shard(index, want):
    """A 2-row halo over 4 shards of 1 row: as many rows as the image has
    on each side, each from its owner's strip."""
    top, bottom, k, it, ib = sp._halo_rows(2, 1, sp.SpatialAxis(None, 4, index))
    assert (top, bottom, k) == (*want, 1)
    # shard j's only row sits at 2j (first strip) and 2j + 1 (last strip)
    assert it == [2 * j + 1 for j in range(index - top, index)]
    assert ib == [2 * j for j in range(index + 1, index + 1 + bottom)]


from torch_spawn import spawn  # noqa: E402

if __name__ == "__main__":
    from torch_spawn import child_main

    child_main({"w_sp": w_sp})
