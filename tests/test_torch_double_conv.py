"""K1 (fused double conv, fold_bn) and K2 (down and up blocks) of the port
held against the JAX package's, the Pallas kernel in interpret mode as
tests/test_pallas.py runs it. On the CPU the port's wrappers run their
plain versions; the same numpy inputs go to both sides."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.ops.pallas import blocks as JB
from image_segmentation_tpu.ops.pallas import double_conv as JD
from image_segmentation_tpu_torch.models.convert import _conv_transpose
from image_segmentation_tpu_torch.ops.kernels import blocks as B
from image_segmentation_tpu_torch.ops.kernels import double_conv as D

torch.set_num_threads(1)

# f32 on both sides: the same convolutions summed in another order, over
# K = 9·Cin ≤ 144 terms of magnitude ≲ 1, twice.
ATOL_F32 = 1e-5
# bf16: both round the intermediate and the output to bf16 at the same
# points, so a value one f32 ulp from a rounding boundary can land one
# bf16 step apart, and move the second conv by about as much.
REL_TOL_BF16 = 2.0**-6


def _args(n=2, h=32, w=40, cin=8, c=16, seed=0, bias1_offset=0.0):
    """test_pallas.py:71-82's inputs, as numpy f32."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    return (f(rng.normal(size=(n, h, w, cin))),
            f(rng.normal(size=(3, 3, cin, c)) * 0.1), f(rng.uniform(0.5, 1.5, c)),
            f(rng.normal(size=c) * 0.1 + bias1_offset),
            f(rng.normal(size=(3, 3, c, c)) * 0.1), f(rng.uniform(0.5, 1.5, c)),
            f(rng.normal(size=c) * 0.1))


def _port(args, dtype=torch.float32):
    # x and the weights in the working dtype, scale and bias f32
    return [torch.from_numpy(a).to(dtype if i in (0, 1, 4) else torch.float32)
            for i, a in enumerate(args)]


def _jax(args, dtype=jnp.float32):
    return [jnp.asarray(a, dtype if i in (0, 1, 4) else jnp.float32)
            for i, a in enumerate(args)]


@pytest.mark.parametrize("strip", [8, 16])
def test_double_conv_matches_pallas_kernel(strip):
    """(2, 32, 40, 8 → 16), f32, atol 1e-5."""
    args = _args()
    want = JD.fused_double_conv(*_jax(args), strip=strip, interpret=True)
    got = D.fused_double_conv(*_port(args))
    assert got.shape == (2, 32, 40, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)


def test_double_conv_stem_and_positive_bias_match_pallas_kernel():
    """The RGB stem's Cin = 3 (the JAX wrapper pads it to 8) and a bias1
    of +1 everywhere, which shows at every edge whether conv2 sees zero
    padding or relu(bias1) outside the image. f32, atol 1e-5."""
    args = _args(n=1, h=16, w=24, cin=3, c=8, seed=1, bias1_offset=1.0)
    want = JD.fused_double_conv(*_jax(args), strip=8, interpret=True)
    got = D.fused_double_conv(*_port(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)


def test_double_conv_bf16_matches_pallas_kernel():
    """bf16 in and out, within 2 bf16 steps of max|JAX|."""
    args = _args(seed=2)
    want = np.asarray(JD.fused_double_conv(*_jax(args, jnp.bfloat16), strip=8,
                                           interpret=True).astype(jnp.float32))
    got = D.fused_double_conv(*_port(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= REL_TOL_BF16 * np.abs(want).max(), err


def test_double_conv_reference_matches_jax_reference():
    """The plain versions of both packages, f32, atol 1e-5."""
    args = _args(seed=3)
    want = JD.reference_double_conv(*_jax(args))
    got = D.double_conv_reference(*_port(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)


@pytest.mark.parametrize("with_conv_bias", [True, False])
def test_fold_bn_matches_jax(with_conv_bias):
    """f32, atol 1e-6, eps 1e-5 on both sides."""
    rng = np.random.default_rng(1)
    c = 8
    bias = rng.normal(size=c).astype(np.float32) if with_conv_bias else None
    stats = [rng.normal(size=c), rng.uniform(0.5, 2.0, c), rng.uniform(0.5, 1.5, c),
             rng.normal(size=c)]
    stats = [s.astype(np.float32) for s in stats]
    want = JD.fold_bn(None if bias is None else jnp.asarray(bias), *map(jnp.asarray, stats))
    got = D.fold_bn(None if bias is None else torch.from_numpy(bias),
                    *map(torch.from_numpy, stats))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_max_pool_and_transpose_conv_match_jax():
    """The blocks' pre-stages, f32, atol 1e-6; the transpose-conv kernel
    is carried across as models/convert.py carries it (flipped)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 12, 6)).astype(np.float32)
    np.testing.assert_allclose(B.max_pool_2x2(torch.from_numpy(x)).numpy(),
                               np.asarray(JB.max_pool_2x2(jnp.asarray(x))), atol=1e-6)
    k = rng.normal(size=(2, 2, 6, 4)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    tw = _conv_transpose({"kernel": k, "bias": b})
    got = B.transpose_conv_2x2(torch.from_numpy(x), tw["weight"], tw["bias"])
    want = JB.transpose_conv_2x2(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    assert got.shape == (2, 16, 24, 4) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_down_block_matches_jax():
    """(2, 32, 32, 8) → pool → (2, 16, 16, 16), f32, atol 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 32, 8)).astype(np.float32)
    _, w1, s1, b1, w2, s2, b2 = _args(cin=8, c=16, seed=5)
    dc = [w1, s1, b1, w2, s2, b2]
    want = JB.fused_down_block(jnp.asarray(x), *map(jnp.asarray, dc), strip=8, interpret=True)
    got = B.fused_down_block(torch.from_numpy(x), *map(torch.from_numpy, dc))
    assert got.shape == (2, 16, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)


def test_up_block_matches_jax_with_skip_first():
    """(1, 16, 16, 16) up ×2 to 8 channels, concat [skip, up] with an
    8-channel skip, double conv to 8; f32, atol 1e-5. The concat order
    matters: [up, skip] gives another answer."""
    rng = np.random.default_rng(1)
    skip = rng.normal(size=(1, 32, 32, 8)).astype(np.float32)
    x = rng.normal(size=(1, 16, 16, 16)).astype(np.float32)
    up_k = (rng.normal(size=(2, 2, 16, 8)) * 0.1).astype(np.float32)
    up_b = (rng.normal(size=8) * 0.1).astype(np.float32)
    _, w1, s1, b1, w2, s2, b2 = _args(cin=16, c=8, seed=6)
    dc = [w1, s1, b1, w2, s2, b2]
    want = np.asarray(JB.fused_up_block(jnp.asarray(skip), jnp.asarray(x), jnp.asarray(up_k),
                                        jnp.asarray(up_b), *map(jnp.asarray, dc), strip=8,
                                        interpret=True))
    tw = _conv_transpose({"kernel": up_k, "bias": up_b})
    t = torch.from_numpy
    got = B.fused_up_block(t(skip), t(x), tw["weight"], tw["bias"], *map(t, dc))
    assert got.shape == (1, 32, 32, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32)
    up = B.transpose_conv_2x2(t(x), tw["weight"], tw["bias"])
    swapped = D.fused_double_conv(torch.cat([up, t(skip)], dim=-1), *map(t, dc))
    assert np.abs(swapped.numpy() - want).max() > 100 * ATOL_F32


@pytest.mark.parametrize("h,cin,c", [(256, 3, 64), (256, 64, 64), (128, 64, 128),
                                     (64, 128, 256), (32, 256, 512), (16, 512, 1024),
                                     (16, 1024, 1024), (32, 1024, 512), (64, 512, 256),
                                     (128, 256, 128), (256, 128, 64), (4, 64, 128)])
def test_k_splits_cover_every_chunk(h, cin, c):
    """`conv_plan`, the cut of one conv, at the UNet-64 and demo levels on
    132 SMs: every K step (chunk, dx) in exactly one split, no empty split,
    at least MIN_STEPS_PER_SPLIT steps a split; no split where the tiles
    fill the SMs; where they do not, the split count whose slowest block
    runs the fewest steps (rounds over the SMs × steps a split, + 1 for the
    reduction), which at these levels keeps every tile × split in one
    round; one persistent block an SM at most."""
    cin = -(-cin // 8) * 8  # the wrapper pads the stem to 8 channels
    plan = D.conv_plan(1, h, h, cin, c, 132)
    assert plan.steps == 3 * -(-cin // D.CHUNK)
    assert (plan.splits - 1) * plan.per_split < plan.steps <= plan.splits * plan.per_split
    tiles = -(-h // D.TILE_H) * -(-h // D.TILE_W) * -(-c // D.CO_TILE)
    assert plan.blocks == min(132, tiles * plan.splits)
    if tiles >= 132:
        assert plan.splits == 1
        return
    cost = lambda s, per: -(-tiles * s // 132) * per + (s > 1)  # noqa: E731
    chosen = cost(plan.splits, plan.per_split)
    for want in range(1, plan.steps // D.MIN_STEPS_PER_SPLIT + 1):
        per = -(-plan.steps // want)
        assert chosen <= cost(-(-plan.steps // per), per)
    if plan.splits > 1:
        assert plan.per_split >= D.MIN_STEPS_PER_SPLIT and tiles * plan.splits <= 132


def test_concat_entry_matches_jax_up_block_with_skip_first():
    """`fused_double_conv_cat(skip, up)`, the up block's double conv with
    the concat in the load stage, against the JAX `fused_up_block` in
    interpret mode (transpose conv, then concat [skip, up], then the Pallas
    double conv), f32, atol 1e-5; channel counts that are not multiples of
    64 (24 + 16). Given [up, skip] instead it gives another answer."""
    rng = np.random.default_rng(7)
    skip = rng.normal(size=(2, 16, 24, 24)).astype(np.float32)
    x = rng.normal(size=(2, 8, 12, 32)).astype(np.float32)
    up_k = (rng.normal(size=(2, 2, 32, 16)) * 0.1).astype(np.float32)
    up_b = (rng.normal(size=16) * 0.1).astype(np.float32)
    _, w1, s1, b1, w2, s2, b2 = _args(cin=40, c=8, seed=8, bias1_offset=0.5)
    dc = [w1, s1, b1, w2, s2, b2]
    want = np.asarray(JB.fused_up_block(jnp.asarray(skip), jnp.asarray(x), jnp.asarray(up_k),
                                        jnp.asarray(up_b), *map(jnp.asarray, dc), strip=8,
                                        interpret=True))
    tw = _conv_transpose({"kernel": up_k, "bias": up_b})
    t = torch.from_numpy
    up = B.transpose_conv_2x2(t(x), tw["weight"], tw["bias"])
    got = D.fused_double_conv_cat(t(skip), up, *map(t, dc))
    assert got.shape == (2, 16, 24, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_F32)
    plain = D.double_conv_cat_reference(t(skip), up, *map(t, dc))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    swapped = D.fused_double_conv_cat(up, t(skip), *map(t, dc))
    assert np.abs(swapped.numpy() - want).max() > 100 * ATOL_F32


def test_wrapper_refuses_other_devices():
    args = _port(_args(n=1, h=8, w=8))
    with pytest.raises(ValueError, match="cpu or cuda"):
        D.fused_double_conv(*[a.to("meta") for a in args])
