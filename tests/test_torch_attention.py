"""K3 in the PyTorch port: the plain version and the CPU routing of
`fused_attention`, held against the JAX package's Pallas kernel run in
interpret mode (as tests/test_pallas.py runs it)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.ops.pallas import attention as jax_attention
from image_segmentation_tpu_torch.ops.kernels import attention as K3

torch.set_num_threads(1)


def _qkv(shape, seed, v_offset=0.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    return q, k, v + np.float32(v_offset)


@pytest.mark.parametrize(
    "shape,v_offset",
    [((2, 197, 12, 64), 0.0), ((1, 5, 2, 16), 0.0), ((1, 130, 2, 64), 10.0)],
)
def test_plain_version_matches_jax_kernel(shape, v_offset):
    """f32, atol 2e-5: the same math, summed in another order. S=130 with
    V offset by +10 shows any attention mass leaking onto padded keys of
    the JAX kernel's 144-row padding."""
    q, k, v = _qkv(shape, seed=0, v_offset=v_offset)
    want = jax_attention.fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    got = K3.attention_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 9, 2, 64), seed=1))
    before = K3.LAUNCHES
    got = K3.fused_attention(q, k, v)
    assert K3.LAUNCHES == before
    torch.testing.assert_close(got, K3.attention_reference(q, k, v), rtol=0, atol=0)


def test_bf16_cast_points():
    """In bf16 the output keeps q's dtype and equals the f32 math on the
    bf16-rounded inputs up to the bf16 rounding of P and of the output."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv((1, 33, 2, 64), seed=2))
    got = K3.attention_reference(q, k, v)
    assert got.dtype == torch.bfloat16
    want = K3.attention_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, rtol=0, atol=3e-2)


def test_wrapper_rejects_other_devices():
    q = torch.zeros(1, 4, 1, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        K3.fused_attention(q, q, q)


@pytest.mark.parametrize("s", [1, 64, 65, 197, 256])
def test_attention_plan_pads_keys_to_chunks(s):
    """The CUDA grid of K3: one block per (64-query tile, head, batch)
    covering every query row once, keys padded to whole 64-key chunks, and
    shared memory for three blocks an SM at every admitted length."""
    plan = K3.attention_plan(8, s, 12)
    assert plan.grid == (-(-s // K3.Q_TILE), 12, 8)
    assert plan.grid[0] * K3.Q_TILE - s < K3.Q_TILE
    assert plan.padded_keys == plan.chunks * K3.KEY_CHUNK
    assert s <= plan.padded_keys < s + K3.KEY_CHUNK
    assert 3 * plan.smem_bytes <= 232448 - 3 * 1024  # the SM's shared memory, with reserves


def test_attention_plan_refuses_past_256():
    with pytest.raises(ValueError, match="256"):
        K3.attention_plan(1, 257, 12)
    with pytest.raises(ValueError, match="256"):
        K3.attention_plan(1, 0, 12)
