"""K4 in the PyTorch port: the plain version, the CPU routing of
`fused_mlp`, and the ViT block's routing rule, held against the JAX
package's Pallas kernel run in interpret mode."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.ops.pallas import mlp as jax_mlp
from image_segmentation_tpu_torch.ops.kernels import mlp as K4

torch.set_num_threads(1)


def _args(b=2, s=197, h=128, f=256, seed=0):
    """Arguments in the JAX layout: kernels (in, out)."""
    rng = np.random.default_rng(seed)
    return [
        (rng.normal(size=(b, s, h)) * 0.5).astype(np.float32),
        rng.normal(size=(h,)).astype(np.float32),
        rng.normal(size=(h,)).astype(np.float32),
        (rng.normal(size=(h, f)) * 0.05).astype(np.float32),
        rng.normal(size=(f,)).astype(np.float32),
        (rng.normal(size=(f, h)) * 0.05).astype(np.float32),
        rng.normal(size=(h,)).astype(np.float32),
    ]


def _torch_args(args):
    """JAX layout → the port's nn.Linear layout (w1 (F, H), w2 (H, F))."""
    x, lw, lb, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args)
    return x, lw, lb, w1.t().contiguous(), b1, w2.t().contiguous(), b2


@pytest.mark.parametrize("b,s", [(2, 197), (1, 131)])
def test_plain_version_matches_jax_kernel(b, s):
    """f32, atol 2e-5 (sum order only). S=131 is not a multiple of the
    JAX kernel's 128-token tile, so its padded rows must not leak."""
    args = _args(b=b, s=s)
    want = jax_mlp.fused_mlp(*(jnp.asarray(a) for a in args), 1e-5, True)
    got = K4.mlp_reference(*_torch_args(args), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    targs = _torch_args(_args(b=1, s=7))
    before = K4.LAUNCHES
    got = K4.fused_mlp(*targs, 1e-5)
    assert K4.LAUNCHES == before
    torch.testing.assert_close(got, K4.mlp_reference(*targs, 1e-5), rtol=0, atol=0)


def test_h64_routes_to_plain_mlp_in_both_packages(monkeypatch):
    """Hidden 64 is not a multiple of 128: neither package may call its
    fused MLP, even with the kernels switched on (clip_vit.py:161)."""
    from image_segmentation_tpu.models import clip_vit as jax_vit
    from image_segmentation_tpu_torch.models import clip_vit as port_vit

    calls = []

    def spy(*a, **k):
        calls.append(1)
        raise AssertionError("fused MLP called at H=64")

    monkeypatch.setattr(jax_mlp, "fused_mlp", spy)
    monkeypatch.setattr(port_vit, "fused_mlp", spy)
    cfg_j = jax_vit.ClipViTConfig(image_size=32, patch_size=16, hidden_size=64,
                                  num_layers=1, num_heads=1, mlp_dim=128)
    x = jnp.zeros((1, 32, 32, 3))
    m = jax_vit.ClipViT(cfg_j, use_pallas=True)
    m.apply(m.init(jax.random.PRNGKey(0), x), x)

    cfg_p = port_vit.ClipViTConfig(image_size=32, patch_size=16, hidden_size=64,
                                   num_layers=1, num_heads=1, mlp_dim=128)
    vit = port_vit.ClipViT(cfg_p, use_kernels=True)
    assert not vit.encoder.layers[0].fuse_mlp
    vit(torch.zeros(1, 32, 32, 3))
    assert calls == []

    wide = port_vit.ClipViT(port_vit.ClipViTConfig(
        image_size=32, patch_size=16, hidden_size=128, num_layers=1,
        num_heads=2, mlp_dim=256), use_kernels=True)
    assert wide.encoder.layers[0].fuse_mlp


def test_h1024_routes_to_plain_mlp_where_k4_takes_no_such_width(monkeypatch):
    """Hidden 1,024 (SAM ViT-L's width) is a multiple of 128 but not in K4's
    HIDDEN_SIZES: the port's ViT block asks K4's own rule (`kernel_takes`)
    and takes the plain MLP, where a card would otherwise raise in K4."""
    from image_segmentation_tpu_torch.models import clip_vit as port_vit

    def spy(*a, **k):
        raise AssertionError("fused MLP called at H=1024")

    monkeypatch.setattr(port_vit, "fused_mlp", spy)
    cfg = port_vit.ClipViTConfig(image_size=32, patch_size=16, hidden_size=1024,
                                 num_layers=1, num_heads=16, mlp_dim=4096)
    vit = port_vit.ClipViT(cfg, use_kernels=True)
    vit(torch.zeros(1, 32, 32, 3))
    assert not vit.encoder.layers[0].fuse_mlp
    assert not K4.kernel_takes(1024, 4096) and K4.kernel_takes(768, 3072)


# SAM 2 Hiera-B+'s four MLPs (models/hiera.py): H and F = 4H.
HIERA_MLPS = ((112, 448), (224, 896), (448, 1792), (896, 3584))


@pytest.mark.parametrize("hdim,fdim", HIERA_MLPS)
def test_kernel_takes_hieras_widths_but_not_in_the_tp_entry(hdim, fdim):
    """Hiera's widths are v3's alone: `kernel_takes` admits them, and the
    TP entry, which runs v2, refuses them when it checks its arguments;
    v2's widths stay admitted for both, and H 1,024 for neither."""
    assert K4.kernel_takes(hdim, fdim)
    assert hdim in K4.MANY_TOKEN_HIDDEN and hdim not in K4.HIDDEN_SIZES
    for h in K4.HIDDEN_SIZES:
        assert K4.kernel_takes(h, 4 * h)
    assert not K4.kernel_takes(1024, 4096)
    assert not K4.kernel_takes(hdim, fdim + 32)
    x, lw, lb, w1, b1, w2, b2 = _torch_args(_args(b=1, s=3, h=hdim, f=fdim))
    args = (x.bfloat16(), lw, lb, w1.bfloat16(), b1, w2.bfloat16(), b2)
    K4._check_cuda_args("fused_mlp", *args)
    with pytest.raises(ValueError, match="TP entry takes H in"):
        K4._check_cuda_args("fused_mlp_partial", *args[:6])


def test_wrapper_rejects_other_devices():
    args = [t.to("meta") for t in _torch_args(_args(b=1, s=3))]
    with pytest.raises(ValueError, match="cpu or cuda"):
        K4.fused_mlp(*args)


@pytest.mark.parametrize("tokens,hdim,fdim", [
    (1, 768, 3072), (197, 768, 3072), (333, 768, 3072), (1576, 768, 3072),
    (6304, 768, 3072), (131, 128, 256), (63, 128, 192), (65, 640, 128), (788, 640, 3072)])
def test_mlp_plan_covers_every_tile_and_split_once(tokens, hdim, fdim):
    """The CUDA grids of K4's v2: every (token tile, F tile) of fc1 in
    exactly one block, every (token tile, H tile) of fc2 once per split,
    every 64-wide chunk of F in exactly one split, no empty run or split,
    and the scratch shapes the kernels index. The v2 plan at every token
    count is the TP entry's (`tp`), which never runs v3."""
    sms = 132
    plan = K4.mlp_plan(tokens, hdim, fdim, sms, tp=True)
    assert isinstance(plan, K4.MlpPlan)
    tt = -(-tokens // K4.TOKEN_TILE)
    assert plan.token_tiles == tt
    f_tiles = -(-fdim // K4.OUT_TILE)
    fc1 = [(t, plan.tiles_per_run * r + i) for t in range(tt) for r in range(plan.runs)
           for i in range(plan.tiles_per_run) if plan.tiles_per_run * r + i < f_tiles]
    assert sorted(fc1) == [(t, f) for t in range(tt) for f in range(f_tiles)]
    assert all(plan.tiles_per_run * r < f_tiles for r in range(plan.runs))
    k_chunks = fdim // K4.K_CHUNK
    chunks = [plan.chunks_per_split * s + i for s in range(plan.splits)
              for i in range(plan.chunks_per_split) if plan.chunks_per_split * s + i < k_chunks]
    assert chunks == list(range(k_chunks))
    assert all(plan.chunks_per_split * s < k_chunks for s in range(plan.splits))
    assert plan.g_shape == (tokens, fdim)
    assert plan.partial_shape == ((plan.splits, tokens, hdim) if plan.splits > 1 else None)
    out_tiles = tt * hdim // K4.OUT_TILE
    if out_tiles >= sms:
        assert plan.splits == 1  # enough output tiles: no partials
    else:
        assert out_tiles * plan.splits <= 2 * sms  # fc2 blocks fit two an SM, one wave


def test_mlp_plan_fc1_fits_one_wave_where_it_can():
    """fc1 holds one block an SM: at one request every block takes one F
    tile; at a batch of 8 the runs are cut so the grid fits one wave."""
    one = K4.mlp_plan(197, 768, 3072, 132)
    assert one.tiles_per_run == 1 and one.token_tiles * one.runs <= 132
    eight = K4.mlp_plan(1576, 768, 3072, 132)
    assert eight.token_tiles * eight.runs <= 132


@pytest.mark.parametrize("tokens,hdim,fdim,tp,many", [
    (197, 768, 3072, False, False), (1576, 768, 3072, False, False),
    (6304, 128, 256, False, False), (32768, 768, 3072, True, False),
    (32768, 768, 3072, False, True), (32700, 768, 3072, False, True),
    (32768, 128, 512, False, False), (32768, 640, 2560, False, False),
    (3151, 768, 3072, False, False), (3152, 768, 3072, False, True)]
    + [(t, h, f, False, True) for h, f in HIERA_MLPS for t in (1, 197, 1024, 3151, 8 * 65536)])
def test_mlp_plan_routes_many_tokens_to_v3(tokens, hdim, fdim, tp, many):
    """v3 takes MANY_TOKENS tokens or more at 768, a width both designs
    build, and every token count at a width only v3 builds (Hiera's: one
    image's 1,024 tokens of stage 4 among them); one request and a ClipUNet
    batch of 8, v2's other widths at any count, and the TP entry keep v2
    (the same cut as before v3 existed). A v3 plan holds v3's scratch
    alone: G and a LayerNorm scratch of x's shape."""
    plan = K4.mlp_plan(tokens, hdim, fdim, 132, tp=tp)
    assert isinstance(plan, K4.ManyTokenPlan) is many
    v3_only = hdim not in K4.HIDDEN_SIZES
    assert (hdim in K4.MANY_TOKEN_HIDDEN and (tokens >= K4.MANY_TOKENS or v3_only)
            and not tp) is many
    if many:
        assert plan == K4.ManyTokenPlan(g_shape=(tokens, fdim), ln_shape=(tokens, hdim))
        assert [f.name for f in dataclasses.fields(plan)] == ["g_shape", "ln_shape"]
    else:
        assert isinstance(plan, K4.MlpPlan)
        assert plan == K4.mlp_plan(tokens, hdim, fdim, 132, tp=True)  # the v2 cut


class _FakeLib:
    """Records the C entry points the launcher calls, and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


def _route(monkeypatch, tokens, activation, partial=False, h=768, f=3072):
    """Runs `_launch` on the CPU against _FakeLib (no card: the tensors are
    never touched) at width `h` and hidden width `f` (halved for the TP
    entry); returns the entry point called and the counts moved."""
    lib = _FakeLib()
    monkeypatch.setattr(K4._build, "load", lambda: lib)
    monkeypatch.setattr(K4._build, "sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    e = lambda *s, dt=torch.bfloat16: torch.empty(*s, dtype=dt)  # noqa: E731
    f //= 2 if partial else 1
    args = (e(1, tokens, h), e(h, dt=torch.float32), e(h, dt=torch.float32), e(f, h),
            e(f, dt=torch.float32), e(h, f), None if partial else e(h, dt=torch.float32))
    before = K4.LAUNCHES, K4.MANY_TOKEN_LAUNCHES, K4.PARTIAL_LAUNCHES
    out = K4._launch(*args, 1e-6, activation)
    assert out.shape == args[0].shape
    (name, cargs), = lib.calls
    moved = (K4.LAUNCHES - before[0], K4.MANY_TOKEN_LAUNCHES - before[1],
             K4.PARTIAL_LAUNCHES - before[2])
    return name, cargs, moved


@pytest.mark.parametrize("activation", ["gelu", "quick_gelu"])
def test_launcher_runs_v3_at_sam_tokens_with_either_gelu(monkeypatch, activation):
    """SAM's micro-batch of 8 (32,768 tokens) goes to the many-token entry
    with the activation's number, and counts in LAUNCHES and
    MANY_TOKEN_LAUNCHES."""
    name, cargs, moved = _route(monkeypatch, 32768, activation)
    assert name == "istpu_mlp_many_bf16" and moved == (1, 1, 0)
    assert cargs[15] == K4.ACTIVATIONS[activation]
    assert cargs[10:14] == (32768, 768, 3072, 132)


@pytest.mark.parametrize("hdim,fdim", HIERA_MLPS)
@pytest.mark.parametrize("tokens", [1024, 8 * 32 * 32])
def test_launcher_runs_v3_at_hieras_widths(monkeypatch, hdim, fdim, tokens):
    """A Hiera MLP (exact GELU, eps 1e-6) goes to the many-token entry at
    one image's tokens of stage 4 and at a micro-batch of 8's, whatever the
    width, and counts in LAUNCHES and MANY_TOKEN_LAUNCHES."""
    name, cargs, moved = _route(monkeypatch, tokens, "gelu", h=hdim, f=fdim)
    assert name == "istpu_mlp_many_bf16" and moved == (1, 1, 0)
    assert cargs[10:14] == (tokens, hdim, fdim, 132) and cargs[15] == K4.ACTIVATIONS["gelu"]


def test_tp_entry_refuses_hieras_widths(monkeypatch):
    """The TP entry runs v2, which builds none of Hiera's widths: the
    launcher refuses one before it calls the library."""
    with pytest.raises(ValueError, match="TP entry takes H in"):
        _route(monkeypatch, 1024, "quick_gelu", partial=True, h=448, f=3584)


@pytest.mark.parametrize("tokens,activation,partial,entry", [
    (197, "quick_gelu", False, "istpu_mlp_bf16"), (1576, "quick_gelu", False, "istpu_mlp_bf16"),
    (197, "gelu", False, "istpu_mlp_bf16"), (32768, "quick_gelu", True, "istpu_mlp_partial_bf16")])
def test_launcher_keeps_v2_for_few_tokens_and_the_tp_entry(monkeypatch, tokens, activation,
                                                           partial, entry):
    name, _, moved = _route(monkeypatch, tokens, activation, partial)
    assert name == entry and moved == ((0, 0, 1) if partial else (1, 0, 0))
