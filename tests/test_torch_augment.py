"""The port's augmentation held against the JAX package's.

Online (`ops/augment.py`): a jax.random key cannot be replayed in torch,
so each test takes JAX's own draws, made with the same jax.random calls
the JAX function makes, and hands the values to the port. JAX runs op by
op (`jax.disable_jit()`), each op rounded as its source writes it: under
jit XLA contracts multiply-adds into FMAs and folds the rotation's
1/(1/x), which moves JAX's own jitted rotation up to 3e-5 from its
op-by-op run; the port computes what the source writes. Sizes 32, 128
and 256 px give the coarse dropout 1, 3 and 5 cells. Images within 1e-5
absolute (f32 both sides; the same index arithmetic). Labels equal,
except pixels whose f32 source coordinate lies within 1e-4 of a rounding
tie: the tests count those and allow only them.

Offline (`data/augment.py`): the same numpy on the same
`np.random.default_rng(seed)`, so the samples are equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.data import augment as jax_offline
from image_segmentation_tpu.data.dataset import ArrayDataset as JaxArrayDataset
from image_segmentation_tpu.ops import augment as J
from image_segmentation_tpu_torch.data import augment as offline
from image_segmentation_tpu_torch.data.dataset import ArrayDataset, U8ArrayDataset
from image_segmentation_tpu_torch.ops import augment as P

torch.set_num_threads(1)

ATOL = 1e-5
TIE = 1e-4
SIZES = [(4, 32), (2, 128), (2, 256)]
GEOMETRIC = ("rotation", "center_crop", "random_crop")


def _batch(n, size, seed=0):
    """Smooth-free test images (uniform noise) and random class ids: every
    sample's neighbours differ, so a moved sample shows."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    lab = rng.integers(0, 4, (n, size, size)).astype(np.int32)
    return img, lab


def _jax_values(name, key, size):
    """The draws JAX's augmenter `name` makes from `key` (ops/augment.py
    :105-203), as a dict of numpy values."""
    if name == "rotation":
        return {"angle": jax.random.uniform(key, (), minval=45.0, maxval=315.0)}
    if name == "random_crop":
        k1, k2, k3 = jax.random.split(key, 3)
        s = jax.random.uniform(k1, (), minval=0.5, maxval=1.0)
        return {"crop_s": s,
                "crop_oy": jax.random.uniform(k2, (), maxval=(size - 1.0) * (1.0 - s)),
                "crop_ox": jax.random.uniform(k3, (), maxval=(size - 1.0) * (1.0 - s))}
    if name == "masking":
        cells = max(1, int(round(size / 50)))
        return {"keep": jax.random.uniform(key, (cells, cells)) >= 0.15}
    if name == "laplace":
        k1, k2 = jax.random.split(key)
        return {"noise_scale": jax.random.uniform(k1, (), minval=0.1, maxval=0.3),
                "noise": jax.random.laplace(k2, (size, size, 3))}
    if name == "contrast":
        return {"alpha": jax.random.uniform(key, (), minval=0.2, maxval=0.6)}
    return {}


def _jax_affine(name, values, size):
    """JAX's 2×3 map for a geometric augmenter, built by JAX."""
    if name == "rotation":
        rad = jnp.float32(values["angle"]) * (jnp.pi / 180.0)
        fit = 1.0 / (jnp.abs(jnp.cos(rad)) + jnp.abs(jnp.sin(rad)))
        return np.asarray(J._center_affine(fit, rad, size))
    if name == "center_crop":
        off = (1.0 - 0.75) * size / 2.0
        return np.asarray(jnp.array([[0.75, 0.0, off], [0.0, 0.75, off]], jnp.float32))
    s, oy, ox = (values[k] for k in ("crop_s", "crop_oy", "crop_ox"))
    return np.asarray(jnp.array([[s, 0.0, oy], [0.0, s, ox]], jnp.float32))


def _ties(A, size):
    """Pixels whose f32 source coordinate, as JAX computes it, lies within
    TIE of a rounding tie (x.5): nearest may round them either way."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    A = A.astype(np.float32)
    sy = A[0, 0] * yy + A[0, 1] * xx + A[0, 2]
    sx = A[1, 0] * yy + A[1, 1] * xx + A[1, 2]
    near = lambda v: np.abs(np.abs(v - np.floor(v)) - 0.5) < TIE  # noqa: E731
    return near(sy) | near(sx)


def _params(values_per_sample, n, size, sel=None, use=None):
    """An AugmentParams from per-sample JAX values; fields an augmenter does
    not read are zeros."""
    cells = max(1, int(round(size / 50)))
    fields = {"angle": (), "crop_s": (), "crop_oy": (), "crop_ox": (),
              "keep": (cells, cells), "noise_scale": (), "noise": (size, size, 3), "alpha": ()}
    cols = {}
    for f, shape in fields.items():
        dtype = bool if f == "keep" else np.float32
        cols[f] = torch.from_numpy(np.stack([
            np.asarray(v[f], dtype) if f in v else np.zeros(shape, dtype)
            for v in values_per_sample]))
    sel = torch.zeros(n, dtype=torch.int64) if sel is None else sel
    use = torch.ones(n, dtype=torch.bool) if use is None else use
    return P.AugmentParams(sel=sel, use=use, **cols)


def _check(got, want, allowed_label_diff):
    gi, gl = got
    wi, wl = (np.asarray(a) for a in want)
    np.testing.assert_allclose(gi.numpy(), wi, rtol=0, atol=ATOL)
    assert gl.dtype == torch.int32
    differ = gl.numpy() != wl
    assert not (differ & ~allowed_label_diff).any(), int((differ & ~allowed_label_diff).sum())
    return int(differ.sum())


@pytest.mark.parametrize("n,size", SIZES)
@pytest.mark.parametrize("name", P.AUGMENTER_NAMES)
def test_each_augmenter_matches_jax(name, n, size):
    img, lab = _batch(n, size, seed=size)
    keys = jax.random.split(jax.random.PRNGKey(size + 7), n)
    jax_fn = J.AUGMENTERS[J.AUGMENTER_NAMES.index(name)]
    with jax.disable_jit():
        want = jax.vmap(jax_fn)(jnp.asarray(img), jnp.asarray(lab), keys)
    values = [jax.tree_util.tree_map(np.asarray, _jax_values(name, k, size)) for k in keys]
    params = _params(values, n, size)
    fn = dict(P.AUGMENTERS)[name]
    got = fn(torch.from_numpy(img), torch.from_numpy(lab), params)
    allowed = np.zeros((n, size, size), bool)
    if name in GEOMETRIC:
        allowed = np.stack([_ties(_jax_affine(name, v, size), size) for v in values])
    _check(got, want, allowed)
    if name == "masking":
        # the dropped cells zero the label too, and the grid has the
        # expected number of cells
        assert params.keep.shape[1] == {32: 1, 128: 3, 256: 5}[size]
        dropped = ~np.asarray(want[0] != 0).any(-1)
        assert (got[1].numpy()[dropped] == 0).all()


@pytest.mark.parametrize("n,size", [(16, 32), (8, 128), (4, 256)])
def test_random_augment_batch_replays_jax(n, size):
    """JAX's key splits replayed into a params tensor: split(key, N), then
    k_sel, k_gate, k_aug per sample; the port's apply_augment_batch of it
    matches JAX's random_augment_batch."""
    img, lab = _batch(n, size, seed=1)
    key = jax.random.PRNGKey(11 + size)
    with jax.disable_jit():
        want = J.random_augment_batch(jnp.asarray(img), jnp.asarray(lab), key)
    sel, use, values, allowed = [], [], [], np.zeros((n, size, size), bool)
    for i, k in enumerate(jax.random.split(key, n)):
        k_sel, k_gate, k_aug = jax.random.split(k, 3)
        idx = int(jax.random.randint(k_sel, (), 0, len(J.AUGMENTERS)))
        gate = bool(jax.random.uniform(k_gate) < 0.5)
        name = P.AUGMENTER_NAMES[idx]
        v = jax.tree_util.tree_map(np.asarray, _jax_values(name, k_aug, size))
        sel.append(idx)
        use.append(gate)
        values.append(v)
        if gate and name in GEOMETRIC:
            allowed[i] = _ties(_jax_affine(name, v, size), size)
    params = _params(values, n, size, sel=torch.tensor(sel), use=torch.tensor(use))
    got = P.apply_augment_batch(torch.from_numpy(img), torch.from_numpy(lab), params)
    _check(got, want, allowed)
    # rows the gate leaves alone are the input, bit for bit
    same = ~np.asarray(use)
    np.testing.assert_array_equal(got[0].numpy()[same], img[same])


def test_cpu_cos_sin_are_xla_cpus_and_float64_rounding_is_not(monkeypatch):
    """The rotation's cos and sin on the CPU equal jnp.cos and jnp.sin on
    XLA's CPU backend bit for bit over 3000 angles of U(45°, 315°). The
    float64 values rounded to f32 (the card's) differ from them by an ulp
    on 0.5-5% of the angles, and at 256 px such an angle moves the rotated
    image past the 1e-5 the parity tests hold: why the CPU keeps the C
    library's values."""
    deg = torch.from_numpy(np.random.default_rng(0).uniform(45, 315, 3000).astype(np.float32))
    rad = deg * (math.pi / 180.0)
    cos, sin = P._cos_sin(rad)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jnp.cos(jnp.asarray(rad.numpy()))))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jnp.sin(jnp.asarray(rad.numpy()))))

    def rounded(r):
        return torch.cos(r.double()).float(), torch.sin(r.double()).float()

    c64, s64 = rounded(rad)
    differ = ((c64 != cos) | (s64 != sin)).nonzero().flatten()
    assert 0.005 < differ.numel() / 3000 < 0.05, differ.numel()
    img, lab = (torch.from_numpy(a) for a in _batch(1, 256, seed=4))
    moved = 0.0
    for i in differ[:8].tolist():
        want = P.rotate_fit(img, lab, deg[i:i + 1])[0]
        with monkeypatch.context() as m:
            m.setattr(P, "_cos_sin", rounded)
            got = P.rotate_fit(img, lab, deg[i:i + 1])[0]
        moved = max(moved, (got - want).abs().max().item())
    assert moved > ATOL, moved


def test_draws_follow_jax_distributions():
    """4096 draws: the identity share 0.5 ± 0.03 and each augmenter
    1/16 ± 0.015; every value inside its range."""
    n, size = 4096, 32
    p = P.draw_augment_params(n, size, torch.Generator().manual_seed(0))
    assert abs((~p.use).float().mean().item() - 0.5) <= 0.03
    for k in range(len(P.AUGMENTER_NAMES)):
        share = (p.use & (p.sel == k)).float().mean().item()
        assert abs(share - 1 / 16) <= 0.015, (P.AUGMENTER_NAMES[k], share)
    assert 45 <= p.angle.min() and p.angle.max() < 315
    assert 0.5 <= p.crop_s.min() and p.crop_s.max() < 1
    bound = (size - 1.0) * (1.0 - p.crop_s)
    assert (p.crop_oy >= 0).all() and (p.crop_oy <= bound).all() and (p.crop_ox <= bound).all()
    assert 0.1 <= p.noise_scale.min() and p.noise_scale.max() < 0.3
    assert 0.2 <= p.alpha.min() and p.alpha.max() < 0.6
    assert abs(p.keep.float().mean().item() - 0.85) < 0.02 and p.keep.shape[1:] == (1, 1)
    # unit Laplace: mean 0, mean |x| 1, variance 2
    x = p.noise[:256].double()
    assert abs(x.mean().item()) < 0.01 and abs(x.abs().mean().item() - 1) < 0.01
    assert abs(x.var().item() - 2) < 0.05


def test_random_augment_batch_is_seeded_and_keeps_dtypes():
    img, lab = _batch(8, 32)
    ti, tl = torch.from_numpy(img), torch.from_numpy(lab).long()
    a = P.random_augment_batch(ti, tl, torch.Generator().manual_seed(5))
    b = P.random_augment_batch(ti, tl, torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].dtype == torch.float32 and a[1].dtype == torch.int64
    assert a[0].shape == ti.shape and a[1].shape == tl.shape
    assert torch.equal(ti, torch.from_numpy(img))  # the input is not written


def test_blur_pads_five_before_and_six_after():
    """A single bright pixel at row 0 spreads to rows 0..5 (SAME, 5 before,
    6 after: output row i sums input rows i-5..i+6) and at the last row to
    rows S-7..S-1: exactly JAX's."""
    size = 32
    img = np.zeros((1, size, size, 3), np.float32)
    img[0, 0, 10], img[0, size - 1, 20] = 1.0, 1.0
    lab = np.zeros((1, size, size), np.int32)
    got = P.average_blur(torch.from_numpy(img), torch.from_numpy(lab))[0][0, :, :, 0].numpy()
    want = np.asarray(J.average_blur(jnp.asarray(img[0]), jnp.asarray(lab[0]))[0])[..., 0]
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (np.nonzero(got[:, 10])[0] == np.arange(0, 6)).all()
    assert (np.nonzero(got[:, 20])[0] == np.arange(size - 7, size)).all()


# ---- offline pipeline ----

def _host_items(n=6, seed=0):
    """Six synthetic images of odd sizes: a cat box, a dog box or both."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        lab = np.zeros((h, w), np.int32)
        lab[h // 4: 3 * h // 4, : w // 2] = 1 + i % 2
        if i % 3 == 0:
            lab[: h // 5, w // 2:] = 2
        lab[:, w // 2] = 255
        items.append((img, lab))
    return items


@pytest.mark.parametrize("name", list(offline.AUGMENTERS))
def test_offline_augmenter_matches_jax(name):
    for img, lab in _host_items(3):
        gi, gl = offline.AUGMENTERS[name](img, lab, np.random.default_rng(4), 64)
        wi, wl = jax_offline.AUGMENTERS[name](img, lab, np.random.default_rng(4), 64)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        assert gi.dtype == wi.dtype and gl.dtype == wl.dtype


def test_offline_merges_match_jax():
    items = [offline.pad_to_square_resize(i, l, 64) for i, l in _host_items()]
    got = offline.generate_combinations(items[:3], items[3:], 4, np.random.default_rng(2), 64)
    want = jax_offline.generate_combinations(items[:3], items[3:], 4,
                                             np.random.default_rng(2), 64)
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    img, lab = _host_items(2)[1]
    np.testing.assert_array_equal(
        offline.combine_images_preserve_aspect_ratio(img, img[:, :20], 64),
        jax_offline.combine_images_preserve_aspect_ratio(img, img[:, :20], 64))


def test_generate_augmented_dataset_matches_jax():
    """Six images through the balanced expansion: the same samples in the
    same order, uint8 images and labels equal."""
    items = _host_items()
    got = offline.generate_augmented_dataset(ArrayDataset(items), seed=3, size=64)
    want = jax_offline.generate_augmented_dataset(JaxArrayDataset(items), seed=3, size=64)
    assert isinstance(got, U8ArrayDataset) and len(got) == len(want) > len(items)
    for g, w in zip(got.items, want.items):
        assert g[0].dtype == np.uint8
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
    assert [offline._dominant_animal(lab) for _, lab in items] == \
        [jax_offline._dominant_animal(lab) for _, lab in items]
