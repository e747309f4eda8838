"""Tensor parallelism over the ViT (parallel/tp.py, models/clip_vit.py) held
against the JAX package on one device: a ClipUNet forward and a full SGD
train step with `freeze_encoder=False` on a (data 2 × model 2) mesh of 4
CPU processes (tests/torch_spawn.py), each pinned to JAX's single-device
result as JAX's test_tp.py pins its own; the gradients of the split
parameters are summed over the data group only (train/steps.py). Plus the
spec rules and what stays whole.
"""
import os

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.clip_unet import ClipUNet
from image_segmentation_tpu_torch.models.clip_vit import ClipViT, ClipViTConfig
from image_segmentation_tpu_torch.parallel import mesh as M
from image_segmentation_tpu_torch.parallel import tp
from image_segmentation_tpu_torch.train.state import TrainState
from image_segmentation_tpu_torch.train.steps import local_step_rows, train_step

torch.set_num_threads(1)

FWD = dict(vit=ClipViTConfig(image_size=32, patch_size=16, hidden_size=64, num_layers=2,
                             num_heads=4, mlp_dim=128),
           skip_indices=(1, 2), decoder_channels=(32, 16, 8))
# patch 8 on 32 px: three up blocks with three skips bring the logits to
# the labels' resolution (test_tp.py:80-88)
STEP = dict(vit=ClipViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=3,
                              num_heads=4, mlp_dim=128),
            skip_indices=(1, 2, 3), decoder_channels=(32, 16, 8, 8))
LR = 0.1


def _data():
    x = np.random.default_rng(0).uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    rng = np.random.default_rng(1)
    x2 = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    y2 = rng.integers(0, 4, (4, 32, 32))
    return x, x2, y2


def w_tp(rank, world, fwd_path, step_path):
    """dp2 x tp2: the forward of this rank's rows, then one SGD step."""
    x, x2, y2 = (torch.from_numpy(a) for a in _data())
    mesh = M.get_mesh("cpu", model_parallel=2)
    rows = torch.from_numpy(local_step_rows(4, 1, mesh))
    net = ClipUNet(num_classes=4, **FWD)
    net.load_state_dict(torch.load(fwd_path))
    tp.shard_params_tp(net, mesh)
    net.eval()
    with torch.no_grad():
        forward = net(x[rows])
    net = ClipUNet(num_classes=4, freeze_encoder=False, **STEP)
    net.load_state_dict(torch.load(step_path))
    tp.shard_params_tp(net, mesh, encoder_prefix="encoder")
    net = net.to(memory_format=torch.channels_last)
    st = TrainState(net, torch.optim.SGD(net.parameters(), lr=LR))
    loss = float(train_step(st, DiceCELoss(ignore_index=None), x2[rows], y2[rows]))
    return {"forward": forward, "loss": loss, "rows": rows,
            "state": {k: v.clone() for k, v in net.state_dict().items()},
            "q_shape": tuple(net.vision_model.encoder.layers[0].self_attn.q_proj.weight.shape)}


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """JAX's inits (as port state dicts), its forward, and its
    single-device SGD step."""
    import jax
    import jax.numpy as jnp
    import optax

    from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
    from image_segmentation_tpu.models.clip_unet import ClipUNet as JaxClipUNet
    from image_segmentation_tpu.models.clip_vit import ClipViTConfig as JaxCfg
    from image_segmentation_tpu.train import create_train_state
    from image_segmentation_tpu.train.steps import make_train_step
    from image_segmentation_tpu_torch.models.convert import from_jax_variables

    to_port = lambda v: from_jax_variables(jax.tree_util.tree_map(np.asarray, v))  # noqa: E731
    jcfg = lambda c: JaxCfg(**{k: getattr(c, k) for k in (  # noqa: E731
        "image_size", "patch_size", "hidden_size", "num_layers", "num_heads", "mlp_dim")})
    x, x2, y2 = _data()
    d = tmp_path_factory.mktemp("tp")
    model = JaxClipUNet(num_classes=4, vit=jcfg(FWD["vit"]), skip_indices=FWD["skip_indices"],
                        decoder_channels=FWD["decoder_channels"])
    v = model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    forward = np.asarray(model.apply(v, jnp.asarray(x), train=False))
    torch.save(to_port(v), d / "fwd.pt")
    model = JaxClipUNet(num_classes=4, vit=jcfg(STEP["vit"]), skip_indices=STEP["skip_indices"],
                        decoder_channels=STEP["decoder_channels"], freeze_encoder=False)
    st = create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                            optax.sgd(LR))
    torch.save(to_port({"params": st.params, "batch_stats": st.batch_stats}), d / "step.pt")
    st, loss = make_train_step(JaxDiceCE(ignore_index=None))(
        st, (jnp.asarray(x2), jnp.asarray(y2.astype(np.int32))))
    want = {k: t.numpy() for k, t in to_port(
        {"params": st.params, "batch_stats": st.batch_stats}).items()}
    return str(d / "fwd.pt"), str(d / "step.pt"), forward, float(loss), want


@pytest.fixture(scope="module")
def tp_run(jax_refs, tmp_path_factory):
    return spawn(os.path.abspath(__file__), "w_tp", 4, tmp_path_factory.mktemp("tp_run"),
                 jax_refs[0], jax_refs[1])


def test_tp_forward_is_jax_forward(jax_refs, tp_run):
    """Each data row's forward of its rows, under dp2 x tp2, is JAX's
    single-device forward of them (test_tp.py:60, atol 2e-5); the model
    ranks of a row agree; q_proj really holds half the heads."""
    want = jax_refs[2]
    for r in tp_run:
        np.testing.assert_allclose(r["forward"].numpy(), want[r["rows"].numpy()], atol=2e-5)
        assert r["q_shape"] == (32, 64)


def test_tp_train_step_is_jax_step(jax_refs, tp_run):
    """One SGD step with the ViT trained (freeze_encoder=False): the loss,
    the parameters (each split one put back together from its model
    ranks' slices) and the BN statistics are JAX's single-device step's
    (test_tp.py:124: loss 1e-5, atol 5e-5, rtol 1e-4), on both data rows."""
    _, _, _, want_loss, want = jax_refs
    for row in (tp_run[:2], tp_run[2:]):
        for r in row:
            assert abs(r["loss"] - want_loss) < 1e-5
        for k, v in want.items():
            dim = tp.clip_tp_spec(k) if "encoder." in k else None
            got = (row[0]["state"][k] if dim is None else
                   torch.cat([r["state"][k] for r in row], dim))
            np.testing.assert_allclose(got.numpy(), v, atol=5e-5, rtol=1e-4, err_msg=k)


def test_spec_rules():
    pre = "vision_model.encoder.layers.0."
    assert tp.clip_tp_spec(pre + "self_attn.q_proj.weight") == 0
    assert tp.clip_tp_spec(pre + "self_attn.q_proj.bias") == 0
    assert tp.clip_tp_spec(pre + "self_attn.out_proj.weight") == 1
    assert tp.clip_tp_spec(pre + "self_attn.out_proj.bias") is None
    assert tp.clip_tp_spec("encoder.layers.1.mlp.fc1.weight") == 0
    assert tp.clip_tp_spec("encoder.layers.1.mlp.fc2.weight") == 1
    assert tp.clip_tp_spec("encoder.layers.1.mlp.fc2.bias") is None
    assert tp.clip_tp_spec("pre_layrnorm.weight") is None
    assert tp.clip_tp_spec("head.weight") is None


def _rank1_of(t):
    return M.Mesh(1, 0, torch.device("cpu"), model_size=t, model_rank=1)


def test_a_dim_that_does_not_divide_stays_whole():
    """hidden 96 splits 3 ways (one head a rank); F = 128 does not, so the
    MLP stays whole and its block runs as without a model axis (JAX
    tp.py:58-65)."""
    vit = ClipViT(ClipViTConfig(image_size=32, hidden_size=96, num_layers=1, num_heads=3,
                                mlp_dim=128))
    q = vit.encoder.layers[0].self_attn.q_proj.weight.detach().clone()
    tp.shard_params_tp(vit, _rank1_of(3))
    layer = vit.encoder.layers[0]
    assert torch.equal(layer.self_attn.q_proj.weight, q[32:64])
    assert layer.self_attn.q_proj.weight.tp_split_dim == 0
    assert layer.self_attn.out_proj.weight.shape == (96, 32)
    assert layer.mlp.fc1.weight.shape == (128, 96)
    assert not hasattr(layer.mlp.fc1.weight, "tp_split_dim")
    assert layer.self_attn.tp_mesh is not None and layer.tp_mesh is None


def test_heads_must_split_whole():
    vit = ClipViT(ClipViTConfig(image_size=32, hidden_size=64, num_layers=1, num_heads=4,
                                mlp_dim=128))
    with pytest.raises(ValueError, match="4 heads do not split over a model axis of 8"):
        tp.shard_params_tp(vit, _rank1_of(8))


from torch_spawn import spawn  # noqa: E402

if __name__ == "__main__":
    from torch_spawn import child_main

    child_main({"w_tp": w_tp})
