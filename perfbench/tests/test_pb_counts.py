"""The yardstick's arithmetic reproduces the kernel bounds that the port's
kernel table records (PERF.md), from shapes alone."""
import json
import os

import pytest

from perfbench import counts
from perfbench.configs import clipunet_vitb16, unet64

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("n, gflop, bound_ms", [(1, 92.03, 0.0944), (8, 736.25, 0.7444)])
def test_k1_nine_double_convs(n, gflop, bound_ms):
    flops = bound = 0.0
    for side, cin, c in counts.UNET64_LEVELS:
        f, b = counts.k1_counts(n, side, side, cin, c)
        flops += f
        bound += counts.bound_s(f, b)[0]
    assert flops / 1e9 == pytest.approx(gflop, abs=0.01)
    assert bound * 1e3 == pytest.approx(bound_ms, abs=5e-5)


@pytest.mark.parametrize("b, bound_ms", [(1, 0.00036), (8, 0.0029)])
def test_k3_bounds_are_bytes(b, bound_ms):
    t, by = counts.bound_s(*counts.k3_counts(b, 197, 12, 64))
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(bound_ms, rel=0.02)  # as PERF.md rounds it


@pytest.mark.parametrize("tokens, bound_ms, by", [(197, 0.0030, "bytes"),
                                                  (1576, 0.0150, "operations")])
def test_k4_bounds(tokens, bound_ms, by):
    t, which = counts.bound_s(*counts.k4_counts(tokens, 768, 3072))
    assert which == by
    assert t * 1e3 == pytest.approx(bound_ms, abs=5e-5)


def test_unet64_levels_and_flops():
    cfg = _cfg("unet64")
    assert tuple(unet64.levels(cfg)) == counts.UNET64_LEVELS
    assert unet64.forward_flops(cfg) / 1e9 == pytest.approx(96.36, abs=0.01)
    assert unet64.train_flops(cfg) == pytest.approx(3 * unet64.forward_flops(cfg)
                                                    - 2 * 256 * 256 * 9 * 3 * 64)
    model = unet64.reference(cfg)
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"]


def test_clipunet_flops():
    cfg = _cfg("clipunet_vitb16")
    # ViT-B/16 at 224 px: 17.56 G multiply-adds
    assert clipunet_vitb16.vit_flops(cfg) / 1e9 == pytest.approx(35.13, abs=0.01)
    fwd, train = clipunet_vitb16.forward_flops(cfg), clipunet_vitb16.train_flops(cfg)
    dec = fwd - clipunet_vitb16.vit_flops(cfg)
    assert 2 * dec < train - clipunet_vitb16.vit_flops(cfg) < 3 * dec


def test_percent_is_none_without_a_base():
    assert counts.percent(1.0, 0.0) is None
    assert counts.percent(1.0, 4.0) == 25.0
