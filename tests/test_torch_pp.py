"""The GPipe pipeline over the ViT blocks (parallel/pp.py) held against the
JAX package's sequential ClipViT on one device: the final state and every
per-layer hidden state for (stages, micro-batches) = (4, 2) and (2, 4),
and the gradients of the stacked block parameters through the pipeline's
shifts (JAX's test_pp.py: atol 2e-5 forward; atol 1e-3, rtol 1e-4
gradients). The pipelines run in one group of 4 CPU processes of this
file (tests/torch_spawn.py): (4, 2) over a model axis of 4, and (2, 4) on
each data row of a (2 × 2) mesh.
"""
import os

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig, TransformerBlock
from image_segmentation_tpu_torch.parallel import mesh as M
from image_segmentation_tpu_torch.parallel import pp

torch.set_num_threads(1)

CFG = ClipViTConfig(image_size=32, patch_size=16, hidden_size=64, num_layers=4,
                    num_heads=4, mlp_dim=128)


def _stacked(vit_path, grad=False):
    state = torch.load(vit_path)
    return {k: v.requires_grad_(grad) for k, v in
            pp.stack_block_params(state, CFG.num_layers).items()}


def w_pp(rank, world, vit_path, x0_path):
    x0 = torch.load(x0_path)
    block_fn = pp.block_fn_for(TransformerBlock(CFG, use_kernels=False))
    out = {}
    for stages, micro in ((4, 2), (2, 4)):
        mesh = M.get_mesh("cpu", model_parallel=stages)
        stacked = _stacked(vit_path, grad=stages == 4)
        local = pp.shard_stacked_params(stacked, mesh)
        final, per_layer = pp.pipeline_blocks(block_fn, local, x0, mesh, micro)
        out[stages] = (final.detach(), per_layer.detach())
        if stages == 4:
            (final ** 2).sum().backward()
            out["grad"] = {k: v.grad[mesh.model_rank] for k, v in stacked.items()}
    return out


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """JAX's ViT (as the port's state dict), its hidden states, and the
    gradient of sum(final²) through the sequential blocks, stacked in the
    port's names."""
    import jax
    import jax.numpy as jnp

    from image_segmentation_tpu.models.clip_vit import ClipViT as JaxViT
    from image_segmentation_tpu.models.clip_vit import ClipViTConfig as JaxCfg
    from image_segmentation_tpu.models.clip_vit import TransformerBlock as JaxBlock
    from image_segmentation_tpu.parallel.pp import stack_block_params as jax_stack
    from image_segmentation_tpu_torch.models.convert import from_jax_variables

    cfg = JaxCfg(image_size=32, patch_size=16, hidden_size=64, num_layers=4, num_heads=4,
                 mlp_dim=128)
    model = JaxViT(cfg=cfg)
    pixels = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (4, 32, 32, 3)), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), pixels)
    _, hidden = model.apply(variables, pixels)
    block_fn = lambda p, x: JaxBlock(cfg).apply({"params": p}, x)  # noqa: E731
    params = variables["params"]

    def seq_loss(stacked, x):
        h = x
        for i in range(cfg.num_layers):
            h = block_fn(jax.tree.map(lambda a: a[i], stacked), h)
        return jnp.sum(h ** 2)

    grads = jax.grad(seq_loss)(jax_stack(params, cfg.num_layers), hidden[0])
    as_blocks = dict(params, **{f"block_{i}": jax.tree.map(lambda a: a[i], grads)
                                for i in range(cfg.num_layers)})
    to_port = lambda p: from_jax_variables(  # noqa: E731
        {"params": jax.tree_util.tree_map(np.asarray, p)})
    want_grad = {k: v.numpy() for k, v in
                 pp.stack_block_params(to_port(as_blocks), cfg.num_layers).items()}
    d = tmp_path_factory.mktemp("pp")
    torch.save(to_port(params), d / "vit.pt")
    torch.save(torch.from_numpy(np.asarray(hidden[0])), d / "x0.pt")
    return str(d / "vit.pt"), str(d / "x0.pt"), [np.asarray(h) for h in hidden], want_grad


@pytest.fixture(scope="module")
def pp_run(jax_refs, tmp_path_factory):
    return spawn(os.path.abspath(__file__), "w_pp", 4, tmp_path_factory.mktemp("pp_run"),
                 jax_refs[0], jax_refs[1])


@pytest.mark.parametrize("stages,microbatches", [(4, 2), (2, 4)])
def test_pp_forward_is_jax_sequential(stages, microbatches, jax_refs, pp_run):
    hidden = jax_refs[2]
    for r in pp_run:
        final, per_layer = r[stages]
        np.testing.assert_allclose(final.numpy(), hidden[-1], atol=2e-5)
        for i in range(CFG.num_layers):
            np.testing.assert_allclose(per_layer[i].numpy(), hidden[i + 1], atol=2e-5,
                                       err_msg=f"hidden state {i + 1}")


def test_pp_gradients_are_jax_sequential_gradients(jax_refs, pp_run):
    """Each stage's layers' gradients, through the shift's backward (the
    reverse shift), put back in layer order, are jax.grad of the
    sequential blocks (test_pp.py:94: atol 1e-3, rtol 1e-4)."""
    want = jax_refs[3]
    for k, v in want.items():
        got = torch.stack([r["grad"][k] for r in pp_run]).numpy()
        np.testing.assert_allclose(got, v, atol=1e-3, rtol=1e-4, err_msg=k)


def test_stack_roundtrip(jax_refs):
    state = torch.load(jax_refs[0])
    stacked = pp.stack_block_params(state, CFG.num_layers)
    assert stacked["self_attn.q_proj.weight"].shape == (4, 64, 64)
    back = pp.unstack_block_params(stacked)
    blocks = {k: v for k, v in state.items() if k.startswith("encoder.layers.")}
    assert back.keys() == blocks.keys()
    for k, v in blocks.items():
        assert torch.equal(back[k], v)


def test_divisibility_errors_are_jax_s():
    mesh = M.Mesh(1, 0, torch.device("cpu"), model_size=3, model_rank=0)
    stacked = {"w": torch.zeros(4, 2)}
    with pytest.raises(ValueError, match="4 layers not divisible by 3 stages"):
        pp.shard_stacked_params(stacked, mesh)
    mesh = M.Mesh(1, 0, torch.device("cpu"), model_size=2, model_rank=0)
    local = pp.shard_stacked_params(stacked, mesh)
    with pytest.raises(ValueError, match="batch 5 not divisible by 2 microbatches"):
        pp.pipeline_blocks(lambda p, x: x, local, torch.zeros(5, 2), mesh, 2)


from torch_spawn import spawn  # noqa: E402

if __name__ == "__main__":
    from torch_spawn import child_main

    child_main({"w_pp": w_pp})
