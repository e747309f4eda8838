"""The kernel layer's shared seam (ops/kernels/_build.py): every public
kernel entry routes by one rule (`kernel_entry`), and the launch counters
are read and credited through one snapshot (`launch_counts`)."""
import pytest
import torch

from image_segmentation_tpu_torch.ops.kernels import _build
from image_segmentation_tpu_torch.ops.kernels import attention as K3
from image_segmentation_tpu_torch.ops.kernels import double_conv as K1
from image_segmentation_tpu_torch.ops.kernels import mlp as K4
from image_segmentation_tpu_torch.ops.kernels import relpos_attention as K5

torch.set_num_threads(1)


def _rnd(*shape, g):
    return torch.randn(*shape, generator=g)


def _heads(g):
    return [_rnd(2, 6, 2, 16, g=g) for _ in range(3)]


def _mlp(g):
    return [_rnd(1, 5, 32, g=g), _rnd(32, g=g), _rnd(32, g=g), 0.2 * _rnd(64, 32, g=g),
            _rnd(64, g=g), 0.2 * _rnd(32, 64, g=g)]


def _conv(g, cin):
    return [0.2 * _rnd(3, 3, cin, 8, g=g), _rnd(8, g=g), _rnd(8, g=g),
            0.2 * _rnd(3, 3, 8, 8, g=g), _rnd(8, g=g), _rnd(8, g=g)]


# Each public entry, its plain version, and its arguments at a small CPU
# shape: K3; K4 with the exact GELU and its TP entry; K1 and its concat
# entry; K5 over a 2 x 3 map, and its window entry over a 5 x 3 map in
# windows of 3.
ENTRIES = {
    "fused_attention": (K3.fused_attention, K3.attention_reference, lambda g: _heads(g)),
    "fused_mlp": (K4.fused_mlp, K4.mlp_reference,
                  lambda g: _mlp(g) + [_rnd(32, g=g), 1e-6, "gelu"]),
    "fused_mlp_partial": (K4.fused_mlp_partial, K4.mlp_partial_reference,
                          lambda g: _mlp(g) + [1e-5]),
    "fused_double_conv": (K1.fused_double_conv, K1.double_conv_reference,
                          lambda g: [_rnd(1, 5, 6, 4, g=g)] + _conv(g, 4)),
    "fused_double_conv_cat": (K1.fused_double_conv_cat, K1.double_conv_cat_reference,
                              lambda g: [_rnd(1, 5, 6, 4, g=g), _rnd(1, 5, 6, 3, g=g)]
                              + _conv(g, 7)),
    "relpos_attention": (K5.relpos_attention, K5.relpos_attention_reference,
                         lambda g: _heads(g) + [_rnd(3, 16, g=g), _rnd(5, 16, g=g)]),
    "window_relpos_attention": (K5.window_relpos_attention,
                                K5.window_relpos_attention_reference,
                                lambda g: [_rnd(2, 5, 3, 2, 16, g=g) for _ in range(3)]
                                + [_rnd(2, 16, g=g), _rnd(2, 16, g=g), _rnd(5, 16, g=g),
                                   _rnd(5, 16, g=g), 3]),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_is_its_plain_version_on_the_cpu_and_refuses_other_devices(name):
    """On the CPU each entry returns its plain version's bits and counts no
    launch; on a device other than cpu or cuda it raises."""
    entry, reference, make = ENTRIES[name]
    args = make(torch.Generator().manual_seed(0))
    counts = _build.launch_counts()
    got = entry(*args)
    assert _build.launches_since(counts) == {}
    assert torch.equal(got, reference(*args))
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match=f"{name} runs on cpu or cuda, not meta"):
        entry(*meta)


def test_launch_counts_cover_every_counter_and_add_back_a_delta():
    """The snapshot holds each kernel module's counters, a delta is what
    moved, and adding a delta back moves the counters by it."""
    counts = _build.launch_counts()
    assert set(counts) == {("attention", "LAUNCHES"), ("mlp", "LAUNCHES"),
                           ("mlp", "PARTIAL_LAUNCHES"), ("mlp", "MANY_TOKEN_LAUNCHES"),
                           ("double_conv", "LAUNCHES"), ("relpos_attention", "LAUNCHES"),
                           ("relpos_attention", "WINDOW_MAP_LAUNCHES")}
    delta = {("relpos_attention", "LAUNCHES"): 8, ("mlp", "PARTIAL_LAUNCHES"): 2}
    try:
        _build.add_launches(delta)
        assert _build.launches_since(counts) == delta
        assert K5.LAUNCHES == counts[("relpos_attention", "LAUNCHES")] + 8
    finally:
        _build.add_launches({key: -n for key, n in delta.items()})
    assert _build.launch_counts() == counts
