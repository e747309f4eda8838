"""The port's losses held against the JAX package's: DiceCELoss and
DiceNLLLoss values and their gradients with respect to the inputs
(jax.grad against torch autograd), with and without class weights and an
ignore index, on targets where one class is absent; and the float64 host
mirrors against the JAX host mirrors.

Tolerance: 1e-5 on every loss value and every input gradient, relative
where a gradient exceeds 1 (the NLL of a probability p has gradient 1/p,
up to about 1e3 here). Both sides compute in float32 with the same
formulas; only the order of the sums differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
from image_segmentation_tpu.losses import DiceNLLLoss as JaxDiceNLL
from image_segmentation_tpu.losses import host as jax_host
from image_segmentation_tpu_torch.losses import DiceCELoss, DiceNLLLoss
from image_segmentation_tpu_torch.losses import host as port_host

torch.set_num_threads(1)

TOL = 1e-5
WEIGHTS = (0.2047, 1.0272, 1.2293, 1.5388)
CASES = [  # (class_weights, ignore_index, smooth_dice)
    (None, None, 1e-5),
    (WEIGHTS, None, 1.0),
    (None, 3, 1e-5),
    (WEIGHTS, 3, 1e-5),
]


def _inputs(seed=0, shape=(2, 12, 10)):
    """NHWC logits and targets in which class 2 never appears."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, shape + (4,)).astype(np.float32)
    targets = rng.choice(np.array([0, 1, 3]), size=shape).astype(np.int32)
    return logits, targets


def _both(port_loss, jax_loss, x, y):
    """(port value, port input grad, jax value, jax input grad)."""
    xt = torch.tensor(x, requires_grad=True)
    v = port_loss(xt, torch.from_numpy(y).long())
    v.backward()
    jv, jg = jax.value_and_grad(lambda a: jax_loss(a, jnp.asarray(y)))(jnp.asarray(x))
    return v.item(), xt.grad.numpy(), float(jv), np.asarray(jg)


@pytest.mark.parametrize("cw,ignore,smooth", CASES)
def test_dice_ce_value_and_grad_match_jax(cw, ignore, smooth):
    x, y = _inputs()
    kw = dict(class_weights=cw, ignore_index=ignore, smooth_dice=smooth)
    v, g, jv, jg = _both(DiceCELoss(**kw), JaxDiceCE(**kw), x, y)
    assert abs(v - jv) <= TOL
    np.testing.assert_allclose(g, jg, atol=TOL)
    assert np.abs(g).max() > 1e-4  # the gradient is not trivially zero


@pytest.mark.parametrize("cw,ignore,smooth", CASES)
def test_dice_nll_value_and_grad_match_jax(cw, ignore, smooth):
    x, y = _inputs(seed=1)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x), -1))
    kw = dict(class_weights=cw, ignore_index=ignore, smooth_dice=smooth)
    v, g, jv, jg = _both(DiceNLLLoss(**kw), JaxDiceNLL(**kw), probs, y)
    assert abs(v - jv) <= TOL
    np.testing.assert_allclose(g, jg, rtol=TOL, atol=TOL)


def test_out_of_range_targets_one_hot_to_zero_as_in_jax():
    """A target outside [0, C) (the 255 sentinel before remapping) adds
    nothing to Dice or CE, as a jax.nn.one_hot row of zeros."""
    x, y = _inputs(seed=2)
    y[0, :3] = 255
    v, g, jv, jg = _both(DiceCELoss(class_weights=WEIGHTS), JaxDiceCE(class_weights=WEIGHTS),
                         x, y)
    assert abs(v - jv) <= TOL
    np.testing.assert_allclose(g, jg, atol=TOL)


@pytest.mark.parametrize("cw,ignore,smooth", CASES)
def test_host_losses_match_jax_host(cw, ignore, smooth):
    x, y = _inputs(seed=3, shape=(9, 7))
    kw = dict(class_weights=cw, ignore_index=ignore, smooth_dice=smooth)
    assert port_host.dice_ce_loss_np(x, y, DiceCELoss(**kw)) == pytest.approx(
        jax_host.dice_ce_loss_np(x, y, JaxDiceCE(**kw)), abs=1e-12)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x), -1), np.float64)
    assert port_host.dice_nll_loss_np(probs, y, DiceNLLLoss(**kw)) == pytest.approx(
        jax_host.dice_nll_loss_np(probs, y, JaxDiceNLL(**kw)), abs=1e-12)
    # the float64 mirror is the float32 loss to float32 precision
    assert port_host.dice_ce_loss_np(x, y, DiceCELoss(**kw)) == pytest.approx(
        float(DiceCELoss(**kw)(torch.from_numpy(x), torch.from_numpy(y))), abs=TOL)


def test_host_dice_nll_custom_nonlin_runs_the_torch_callable():
    x, y = _inputs(seed=4, shape=(5, 6))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x), -1), np.float64)
    cfg = DiceNLLLoss(nll_nonlin=lambda p: torch.log(p + 1e-3))
    jcfg = JaxDiceNLL(nll_nonlin=lambda p: jnp.log(p + 1e-3))
    assert port_host.dice_nll_loss_np(probs, y, cfg) == pytest.approx(
        jax_host.dice_nll_loss_np(probs, y, jcfg), abs=1e-6)
