"""K5's window entry (`window_relpos_attention`, ops/kernels/relpos_attention.py)
on the CPU: its plain version against SAM's padded route (zero pad after
norm1 → qkv → partition → attention → unpartition → crop), the pad keys'
bias rows, the plan's blocks, its argument checks, and SamViTB's windowed
blocks on the kernel path (which pads nothing) against the plain path."""
import os
import sys

import pytest
import torch
import torch.nn.functional as F

from image_segmentation_tpu_torch.models import sam as S
from image_segmentation_tpu_torch.ops.kernels import relpos_attention as K5

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_sam as T  # noqa: E402

torch.set_num_threads(1)


def _map(b, h, w, nh=2, d=8, seed=0, bias_scale=0.5):
    """A LayerNorm'd (B, h, w, C) map, a qkv projection with a non-zero
    bias, and the two relative tables of a window of 4."""
    g = torch.Generator().manual_seed(seed)
    c = nh * d
    y = torch.randn((b, h, w, c), generator=g)
    qkv = torch.nn.Linear(c, 3 * c)
    with torch.no_grad():
        qkv.weight.copy_(0.3 * torch.randn((3 * c, c), generator=g))
        qkv.bias.copy_(bias_scale * torch.randn((3 * c,), generator=g))
    tables = [torch.randn((7, d), generator=g) for _ in range(2)]
    return y, qkv, tables


def _padded_route(y, qkv, tables, nh, ws):
    """SAM's own order: zero pad → qkv over the padded map → windows →
    relpos_attention_reference → unpartition → crop."""
    b, h, w, c = y.shape
    win, pad_hw = K5.window_partition(y, ws)
    q, k, v = F.linear(win, qkv.weight, qkv.bias).view(
        win.shape[0], ws * ws, 3, nh, c // nh).unbind(2)
    out = K5.relpos_attention_reference(q, k, v, *tables)
    return K5.window_unpartition(out.reshape(-1, ws, ws, c), ws, pad_hw, (h, w))


def _window_route(y, qkv, tables, nh, ws):
    b, h, w, c = y.shape
    q, k, v = F.linear(y, qkv.weight, qkv.bias).view(b, h, w, 3, nh, c // nh).unbind(3)
    bias = qkv.bias.view(3, nh, c // nh)
    out = K5.window_relpos_attention(q, k, v, bias[1], bias[2], *tables, ws)
    return out.reshape(b, h, w, c)


# a map padded on both sides (10 x 9 in windows of 4: 12 x 12) and one that
# the windows tile (8 x 8)
@pytest.mark.parametrize("h,w", [(10, 9), (8, 8)], ids=["padded", "tiled"])
def test_plain_version_is_the_padded_route(h, w):
    y, qkv, tables = _map(2, h, w)
    with torch.no_grad():
        got = _window_route(y, qkv, tables, 2, 4)
        want = _padded_route(y, qkv, tables, 2, 4)
    assert got.shape == (2, h, w, 16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_pad_keys_take_the_bias_and_change_the_answer():
    """With a zero qkv bias the pad keys are zero tokens; with a non-zero
    one they are its k and v rows, and the real queries' answer moves.
    A map the windows tile has no pad key, and the bias rows of k and v
    cannot reach it."""
    with torch.no_grad():
        y, qkv, tables = _map(2, 10, 9)
        q, k, v = F.linear(y, qkv.weight, qkv.bias).view(2, 10, 9, 3, 2, 8).unbind(3)
        bias = qkv.bias.view(3, 2, 8)
        with_bias = K5.window_relpos_attention(q, k, v, bias[1], bias[2], *tables, 4)
        zeros = torch.zeros_like(bias[1])
        without = K5.window_relpos_attention(q, k, v, zeros, zeros, *tables, 4)
        assert (with_bias - without).abs().max() > 1e-2
        # queries of the top-left window see no pad key: unmoved
        torch.testing.assert_close(with_bias[:, :4, :4], without[:, :4, :4], rtol=0, atol=0)
        y, qkv, tables = _map(2, 8, 8)
        q, k, v = F.linear(y, qkv.weight, qkv.bias).view(2, 8, 8, 3, 2, 8).unbind(3)
        other = torch.randn(2, 8)
        assert torch.equal(K5.window_relpos_attention(q, k, v, other, other, *tables, 4),
                           K5.window_relpos_attention(q, k, v, zeros, zeros, *tables, 4))


def test_op_is_the_plain_version_on_the_cpu():
    y, qkv, tables = _map(1, 5, 7)
    with torch.no_grad():
        q, k, v = F.linear(y, qkv.weight, qkv.bias).view(1, 5, 7, 3, 2, 8).unbind(3)
        bias = qkv.bias.view(3, 2, 8)
        args = (q, k, v, bias[1], bias[2], *tables, 4)
        assert torch.equal(K5.window_relpos_attention_op(*args),
                           K5.window_relpos_attention_reference(*args))


@pytest.mark.parametrize("h,w,ws", [(64, 64, 14), (20, 18, 14), (10, 9, 4), (8, 8, 4),
                                    (1, 1, 1), (33, 70, 32)])
def test_plan_takes_each_windows_real_rows_in_blocks_of_two_tiles(h, w, ws):
    """A tile holds 64 / pitch window rows, the pitch the real width's
    next of 8, 16, 32; a block two tiles."""
    sides = lambda n: [min(ws, n - i) for i in range(0, n, ws)]  # noqa: E731
    pitch = lambda c: next(p for p in (8, 16, 32) if c <= p)  # noqa: E731
    want = sum(-(-a // (2 * 64 // pitch(b))) for a in sides(h) for b in sides(w))
    plan = K5.window_plan(8, h, w, 12, ws)
    assert plan.grid == (want, 12, 8) and not plan.row_tiles
    assert plan.smem_bytes == K5.relpos_plan(1, ws * ws, 12, ws, ws).smem_bytes


def test_plan_at_sams_map_needs_41_blocks_of_the_padded_maps_50():
    """SAM's 64 x 64 map in windows of 14: 16 whole windows of 2 blocks (8
    rows of 16 slots, then 6), the 8 edge windows (14 x 8: 16 rows of 8
    slots; 8 x 14: 8 rows of 16) and the 8 x 8 corner of 1 each, where the
    partitioned call over the 70 x 70 map gave each of its 25 windows 2."""
    assert K5.window_query_tiles(64, 64, 14) == 16 * 2 + 8 + 1 == 41
    assert K5.relpos_plan(8 * 25, 196, 12, 14, 14).grid[0] * 25 == 50
    with pytest.raises(ValueError, match="windows"):
        K5.window_plan(1, 64, 64, 12, 33)


def test_window_checks_refuse_what_the_kernel_cannot_take():
    """The checks a CUDA call makes, run on CPU tensors."""
    qkv = torch.zeros((1, 4, 4, 3, 2, 64), dtype=torch.bfloat16)
    q, k, v = qkv.unbind(3)
    bias = torch.zeros((2, 64), dtype=torch.bfloat16)
    table = torch.zeros((7, 64), dtype=torch.bfloat16)
    K5._check_window_args(q, k, v, bias, bias, table, table)
    with pytest.raises(ValueError, match="\\(B, h, w, H, D\\)"):
        K5._check_window_args(q[0], k[0], v[0], bias, bias, table, table)
    with pytest.raises(TypeError, match="bfloat16"):
        K5._check_window_args(q, k, v, bias.float(), bias, table, table)
    with pytest.raises(ValueError, match="bias_k and bias_v"):
        K5._check_window_args(q, k, v, bias[:1], bias[:1], table, table)
    with pytest.raises(ValueError, match="square window"):
        K5._check_window_args(q, k, v, bias, bias, table, table[:5])
    with pytest.raises(RuntimeError):  # rows and columns that do not merge: no copy
        K5._check_window_args(*(t.transpose(1, 2) for t in (q, k, v)), bias, bias, table,
                              table)
    with pytest.raises(ValueError, match="window"):
        K5.window_relpos_attention(q, k, v, bias, bias, table, table, 3)


def _bias_qkv(model, seed=1):
    """A non-zero qkv bias in every encoder block (init_weights zeroes it),
    so that the pad keys differ from zero tokens' projections."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for block in model.image_encoder.blocks:
            block.attn.qkv.bias.copy_(0.5 * torch.randn(block.attn.qkv.bias.shape, generator=g))
    return model


@pytest.mark.parametrize("sam", [T.SMALL, T.UNPADDED], ids=["padded_windows", "tiled_windows"])
def test_kernel_path_matches_the_plain_path(sam, monkeypatch):
    """SamViTB's kernel path (on the CPU: the window entry's plain version,
    over the unpadded map) against its plain path (pad → partition →
    attention → unpartition → crop) at `test_forward_matches_reference`'s
    tolerance, and the kernel path partitions nothing."""
    partitions = []
    real = S.window_partition
    monkeypatch.setattr(S, "window_partition",
                        lambda *a: partitions.append(1) or real(*a))
    plain = _bias_qkv(S.SamViTB(sam).init_weights(torch.Generator().manual_seed(0)))
    kernels = S.SamViTB(sam, use_kernels=True)
    kernels.load_state_dict(plain.state_dict())
    images, clicks, _ = T._batch(sam)
    windowed = sum(1 for i in range(sam.depth) if i not in sam.global_attn_indexes)
    with torch.no_grad():
        got = kernels(images, clicks)
        assert partitions == []
        want = plain(images, clicks)
        assert len(partitions) == windowed
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_kernel_path_counts_the_pad_tokens_as_the_plain_path_does():
    from image_segmentation_tpu_torch.utils import profiling

    counts = []
    for use_kernels in (False, True):
        model = S.SamViTB(T.SMALL, use_kernels=use_kernels).init_weights(
            torch.Generator().manual_seed(0))
        images, clicks, _ = T._batch(T.SMALL, n=3)
        with profiling.record_spans() as log, torch.no_grad():
            model(images, clicks)
        counts.append(dict(log.counts))
    assert counts[0] == counts[1] == {"sam.window_attention": 2, "sam.global_attention": 1,
                                      "sam.window_pad_tokens": 2 * 3 * 20}


def test_windowed_block_hands_k5_the_bias_rows_in_the_compute_dtype(monkeypatch):
    """The kernel path hands K5 the k and v thirds of qkv.bias cast to the
    block's dtype, which is what the projection gives a zero token, and
    the unpadded map's q, k, v as views of one projection."""
    seen = {}

    def spy(q, k, v, bias_k, bias_v, rh, rw, ws):
        seen.update(q=q, k=k, bias_k=bias_k, bias_v=bias_v, ws=ws)
        return K5.window_relpos_attention(q, k, v, bias_k, bias_v, rh, rw, ws)

    monkeypatch.setattr(S, "window_relpos_attention", spy)
    cfg = T.SMALL
    block = S.EncoderBlock(cfg, cfg.window_size, use_kernels=True).to(torch.bfloat16)
    with torch.no_grad():
        block.attn.qkv.bias.normal_()
        block(torch.randn((2, 4, 4, cfg.embed_dim), dtype=torch.bfloat16))
    c, bias = cfg.embed_dim, block.attn.qkv.bias.to(torch.bfloat16)
    assert seen["ws"] == cfg.window_size and seen["q"].shape == (2, 4, 4, 2, c // 2)
    assert seen["q"].untyped_storage().data_ptr() == seen["k"].untyped_storage().data_ptr()
    assert torch.equal(seen["bias_k"].flatten(), bias[c:2 * c])
    assert torch.equal(seen["bias_v"].flatten(), bias[2 * c:])


# -- K5 without tables (SAM 2's Hiera) ----------------------------------------------

def _softmax_attention(q, k, v):
    """softmax(q·kᵀ/√d)·v over (B, S, H, D), written out."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    return torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v)


def _no_table_route(y, qkv, nh, ws):
    """Hiera's own order: zero pad → qkv over the padded map → windows →
    softmax attention → unpartition → crop."""
    b, h, w, c = y.shape
    win, pad_hw = K5.window_partition(y, ws)
    q, k, v = F.linear(win, qkv.weight, qkv.bias).view(
        win.shape[0], ws * ws, 3, nh, c // nh).unbind(2)
    out = _softmax_attention(q, k, v)
    return K5.window_unpartition(out.reshape(-1, ws, ws, c), ws, pad_hw, (h, w))


# Hiera-B+'s windows of 8 (a map they tile), 14 and 7 (maps they pad), at
# head dim 56
@pytest.mark.parametrize("h,w,ws", [(16, 16, 8), (20, 18, 14), (10, 9, 7)])
def test_no_table_window_entry_is_softmax_attention_in_padded_windows(h, w, ws):
    y, qkv, _ = _map(2, h, w, nh=2, d=56)
    b, c = 2, 112
    with torch.no_grad():
        q, k, v = F.linear(y, qkv.weight, qkv.bias).view(b, h, w, 3, 2, 56).unbind(3)
        bias = qkv.bias.view(3, 2, 56)
        got = K5.window_attention_no_tables(q, k, v, bias[1], bias[2], ws)
        want = _no_table_route(y, qkv, 2, ws)
        assert torch.equal(K5.window_attention_no_tables_op(q, k, v, bias[1], bias[2], ws), got)
    assert got.shape == (b, h, w, 2, 56)
    torch.testing.assert_close(got.reshape(b, h, w, c), want, rtol=1e-5, atol=1e-5)


def test_no_table_global_entry_is_softmax_attention():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, 12 * 10, 4, 56), generator=g) for _ in range(3))
    got = K5.attention_no_tables(q, k, v, 12, 10)
    torch.testing.assert_close(got, _softmax_attention(q, k, v), rtol=1e-5, atol=1e-5)
    assert torch.equal(K5.attention_no_tables_op(q, k, v, 12, 10), got)
    with pytest.raises(ValueError, match="tokens"):
        K5.attention_no_tables(q, k, v, 12, 12)


def test_no_table_checks_refuse_other_head_dims_and_tables():
    """The checks a CUDA call makes, run on CPU tensors: no tables takes
    head dim 56 and bias rows of 56; tables take 64; one table alone, a
    map the row-tile mode does not take, and grad are refused."""
    qkv = torch.zeros((1, 4, 4, 3, 2, 56), dtype=torch.bfloat16)
    q, k, v = qkv.unbind(3)
    bias = torch.zeros((2, 56), dtype=torch.bfloat16)
    K5._check_window_args(q, k, v, bias, bias, None, None)
    K5._check_cuda_args(*(t.flatten(1, 2) for t in (q, k, v)), None, None, (4, 4))
    wide = torch.zeros((1, 4, 4, 3, 2, 64), dtype=torch.bfloat16).unbind(3)
    with pytest.raises(ValueError, match="window_attention_no_tables: .*head dim 56"):
        K5._check_window_args(*wide, bias, bias, None, None)
    with pytest.raises(ValueError, match="attention_no_tables: .*head dim 56"):
        K5._check_cuda_args(*(t.flatten(1, 2) for t in wide), None, None, (4, 4))
    table = torch.zeros((7, 56), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="relpos_attention: .*head dim 64"):
        K5._check_window_args(q, k, v, bias, bias, table, table)
    with pytest.raises(ValueError, match="both tables or neither"):
        K5._check_window_args(q, k, v, bias, bias, table, None)
    with pytest.raises(ValueError, match="\\(2, 56\\) table"):
        K5._check_window_args(q, k, v, torch.zeros((2, 64), dtype=torch.bfloat16)[:, :56],
                              bias, None, None)
    with pytest.raises(ValueError, match="tokens"):
        K5._check_cuda_args(*(t.flatten(1, 2) for t in (q, k, v)), None, None, (4, 5))
    with pytest.raises(ValueError, match="row-tile"):
        K5.relpos_plan(1, 16, 2, 4, 4, tables=False)
    with pytest.raises(RuntimeError, match="no backward"):
        K5._check_window_args(q, k, v, bias.clone().requires_grad_(True), bias, None, None)


def test_no_table_plans_leave_out_the_tables_shared_memory():
    """Without tables a block holds no table or term tiles (two 8 KB tiles
    a warpgroup less); the window map's blocks are the same either way."""
    tile = 64 * 64 * 2
    for plan, tabled in ((K5.relpos_plan(8, 4096, 8, 64, 64, tables=False),
                          K5.relpos_plan(8, 4096, 8, 64, 64)),
                         (K5.window_plan(8, 64, 64, 8, 14, tables=False),
                          K5.window_plan(8, 64, 64, 8, 14))):
        assert plan.grid == tabled.grid and plan.row_tiles == tabled.row_tiles
        assert tabled.smem_bytes - plan.smem_bytes == 2 * plan.warpgroups * tile
    assert K5.window_plan(8, 256, 256, 2, 8, tables=False).grid == (32 * 32, 2, 8)
