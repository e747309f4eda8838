"""The port's robustness study (`studies/robustness.py`) held against the
JAX repository's benchmarks/robustness.py.

* Each of the eight perturbations at severities 1, 5 and 10, on one image
  and one `default_rng` seed, equals JAX's exactly (atol 0); `pixelate`
  goes through each package's own `resize_nearest_np`.
* `robustness_sweep` on a base-8 UNet with JAX's weights carried across
  (`from_jax_variables`), on `synthetic_materialized(6, 32, seed=3)` at
  severities [1, 6]: the port's host path and its device path with f32
  transport lie within 2e-4 of JAX's host path, the u8 transport within
  5e-3: JAX's own tolerances between its paths
  (tests/test_ablations.py:88-131)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.models import UNet as JaxUNet
from image_segmentation_tpu.ops import geometry as jax_geometry
from image_segmentation_tpu.run import synthetic_materialized as jax_synthetic
from image_segmentation_tpu.train import create_train_state
from image_segmentation_tpu.train.state import make_adamw as jax_adamw
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.ops import geometry as G
from image_segmentation_tpu_torch.run import synthetic_materialized
from image_segmentation_tpu_torch.studies import robustness as R
from image_segmentation_tpu_torch.train.state import TrainState
from image_segmentation_tpu_torch.train.steps import eval_forward
from test_torch_study_prepare import load_jax_file

torch.set_num_threads(1)

SEVERITIES = [1, 6]


@pytest.fixture(scope="module")
def jax_robustness():
    return load_jax_file("benchmarks/robustness.py", "jax_robustness")


@pytest.fixture(autouse=True)
def numpy_resamplers(monkeypatch):
    """Both packages on their numpy resamplers, so their materialised
    inputs and host inverses are bit-equal (tests/test_torch_loader.py)."""
    monkeypatch.setattr(jax_geometry, "_native", lambda: None)
    monkeypatch.setattr(G, "_native", lambda: None)


def test_the_eight_families_and_their_order(jax_robustness):
    assert list(R.PERTURBATIONS) == list(jax_robustness.PERTURBATIONS)
    assert len(R.PERTURBATIONS) == 8


@pytest.mark.parametrize("sev", [1, 5, 10])
@pytest.mark.parametrize("name", list(R.PERTURBATIONS))
def test_perturbation_equals_jax(jax_robustness, name, sev):
    img = np.random.default_rng(7).uniform(0, 1, (37, 29, 3)).astype(np.float32)
    got = R.PERTURBATIONS[name](img, sev, np.random.default_rng(11))
    want = jax_robustness.PERTURBATIONS[name](img, sev, np.random.default_rng(11))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)  # atol 0


@pytest.fixture(scope="module")
def sweep_models():
    """A base-8 JAX UNet with its BN statistics moved off 0 and 1, and the
    port's UNet carrying the same variables."""
    model = JaxUNet(num_classes=4, base=8, dtype=jnp.float32)
    js = create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                            jax_adamw(1e-3))
    rng = np.random.default_rng(9)
    js = js.replace(batch_stats=jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        js.batch_stats))
    port = UNet(base=8)
    port.load_state_dict(from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, js.params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, js.batch_stats)}))
    return model, js, port.to(memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def jax_host_curves(sweep_models, jax_robustness):
    model, js, _ = sweep_models
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_geometry, "_native", lambda: None)
    try:
        val = jax_synthetic(6, 32, seed=3, keep_orig_labels=True)
        fwd = jax.jit(lambda x: model.apply(
            {"params": js.params, "batch_stats": js.batch_stats}, x, train=False
        ).astype(jnp.float32))
        return jax_robustness.robustness_sweep(fwd, val, num_classes=4,
                                               severities=SEVERITIES, verbose=False)
    finally:
        mp.undo()


def _port_val():
    return synthetic_materialized(6, 32, seed=3, keep_orig_labels=True)


@pytest.mark.parametrize("path,kw,atol", [
    ("host", {}, 2e-4),
    ("device f32", dict(transfer_u8=False), 2e-4),
    ("device u8", {}, 5e-3),
])
def test_sweep_matches_jax_host_path(sweep_models, jax_host_curves, path, kw, atol):
    _, _, port = sweep_models
    if path == "host":
        got = R.robustness_sweep(lambda x: eval_forward(port, x).float(), _port_val(),
                                 num_classes=4, severities=SEVERITIES, verbose=False,
                                 device="cpu")
    else:
        got = R.robustness_sweep(None, _port_val(), num_classes=4, severities=SEVERITIES,
                                 verbose=False, state=TrainState(port), batch_size=4, **kw)
    assert list(got) == list(jax_host_curves)
    for k in jax_host_curves:
        np.testing.assert_allclose(got[k], jax_host_curves[k], atol=atol, err_msg=k)


def test_sweep_families_subset_and_worker_count(sweep_models):
    """A subset of families sweeps only those, and the per-image seeds make
    the curves independent of the worker count (exact)."""
    _, _, port = sweep_models
    fwd = lambda x: eval_forward(port, x).float()  # noqa: E731
    one = R.robustness_sweep(fwd, _port_val(), severities=[3], families=["occlusion", "blur"],
                             verbose=False, device="cpu", workers=1)
    four = R.robustness_sweep(fwd, _port_val(), severities=[3],
                              families=["occlusion", "blur"], verbose=False, device="cpu",
                              workers=4, batch_size=2)
    assert list(one) == ["occlusion", "blur"] and one == four
