"""The port's parity rehearsals (`studies/bn_regime.py`,
`studies/convergence_rehearsal.py`) against the JAX repository's
benchmarks/bn_regime.py and benchmarks/convergence_rehearsal.py.

* bn_regime: each arm's batch, accum_steps and micro-batch are JAX's
  `run_arm` row's, and so its optimizer steps an epoch; from JAX's init
  carried across, after 1 epoch at base 8 and 32 px each arm's val Dice is
  within 5e-3 of JAX's (the bound's reason is at the assertion).
* convergence_rehearsal: the port's `analyze` on the JAX repository's
  recorded benchmarks/convergence_rehearsal_r4.json returns exactly the
  rel_drift, eval_deltas, checks and ok it holds (JAX's check names kept).
  JAX's module is not imported: at import it sets
  jax_default_matmul_precision to highest, which would reach every later
  test of the worker. `--recheck` writes to --out, never over its input
  (which stays byte-equal). A 2-epoch run at T 32 and base 8 passes its
  first-step check: the reference recipe's first loss and the port's
  within 1e-5 relative; its CLI exits non-zero when a check fails.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.losses import DiceCELoss as JaxDiceCE
from image_segmentation_tpu.models import UNet as JaxUNet
from image_segmentation_tpu.ops import geometry as jax_geometry
from image_segmentation_tpu.train import create_train_state
from image_segmentation_tpu.train.state import make_adamw as jax_adamw
from image_segmentation_tpu_torch.losses import DiceCELoss
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.ops import geometry as port_geometry
from image_segmentation_tpu_torch.studies import ablations, bn_regime, convergence_rehearsal
from test_torch_study_prepare import ROOT, load_jax_file

torch.set_num_threads(1)

R4 = os.path.join(ROOT, "benchmarks", "convergence_rehearsal_r4.json")
SIDE, BASE, N_TRAIN, N_VAL = 32, 8, 32, 8


@pytest.fixture(autouse=True)
def numpy_resamplers(monkeypatch):
    """Both packages on their numpy resamplers, so that their materialised
    sets are bit-equal (tests/test_torch_loader.py)."""
    monkeypatch.setattr(jax_geometry, "_native", lambda: None)
    monkeypatch.setattr(port_geometry, "_native", lambda: None)


@pytest.fixture(scope="module")
def jax_bn():
    return load_jax_file("benchmarks/bn_regime.py", "jax_bn_regime")


# -- bn_regime -------------------------------------------------------------

@pytest.mark.parametrize("arm,batch,accum", bn_regime.arms(on_card=False))
def test_bn_regime_arm_equals_jax(jax_bn, arm, batch, accum, capsys):
    jtrain = jax_bn._dataset(N_TRAIN, SIDE, seed=0)
    jval = jax_bn._dataset(N_VAL, SIDE, seed=100, keep_orig=True)
    jloss = JaxDiceCE(class_weights=jax_bn._weights(jtrain, "full"))
    want = jax_bn.run_arm(arm, jtrain, jval, jloss, 1, batch, accum, BASE, jnp.float32, 0)
    init = create_train_state(JaxUNet(num_classes=4, base=BASE, dtype=jnp.float32),
                              jax.random.PRNGKey(0), jnp.asarray(jtrain.images[:1]),
                              jax_adamw(learning_rate=1e-3))
    train = ablations._dataset(N_TRAIN, SIDE, seed=0)
    val = ablations._dataset(N_VAL, SIDE, seed=100, keep_orig=True)
    np.testing.assert_array_equal(train.images, np.asarray(jtrain.images))
    loss = DiceCELoss(class_weights=ablations._weights(train, "full"))
    got = bn_regime.run_arm(arm, train, val, loss, 1, batch, accum, BASE, torch.float32, 0,
                            "cpu", init=from_jax_variables(
                                {"params": jax.tree_util.tree_map(np.asarray, init.params),
                                 "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                       init.batch_stats)}))
    for k in ("arm", "seed", "batch", "accum_steps", "micro_batch"):
        assert got[k] == want[k], k
    assert got["micro_batch"] == (2 if arm == "reference_bn" else batch)
    assert got["steps_per_epoch"] == N_TRAIN // want["batch"]
    # The first AdamW step moves every weight by about ±lr on the sign of its
    # gradient, so the tiny gradients whose sign f32 sums in another order
    # flip take the two packages' weights ~2e-3 apart, and the 8 val images'
    # near-ties among ~3e5 pixels flip with them: after 1 epoch the val Dice
    # agree within 5e-3 (observed 1.0e-4, 3.9e-3, 1.3e-3 by arm; JAX rounds
    # its row to 4 places), as tests/test_torch_fit.py bounds its val metrics
    assert abs(got["final_dice"] - want["final_dice"]) <= 5e-3
    assert abs(got["best_dice"] - want["best_dice"]) <= 5e-3


def test_bn_regime_summary_deltas():
    rows = [{"arm": a, **{k: v + i for k in bn_regime.METRICS}}
            for i, a in enumerate(("reference_bn", "batch64_bn", "production_bn"))
            for v in (0.1, 0.3)]
    s = bn_regime.summarize(rows, 32, 2, 8, 64, ["reference_bn", "batch64_bn", "production_bn"])
    assert s["arms"]["batch64_bn"]["best_dice"]["mean"] == pytest.approx(1.2)
    assert s["delta_reference_minus_batch64"]["best_dice"] == pytest.approx(-1.0)
    assert s["delta_reference_minus_production"]["best_miou"] == pytest.approx(-2.0)


# -- convergence_rehearsal ---------------------------------------------------

def test_analyze_rederives_the_jax_record():
    with open(R4) as f:
        artifact = json.load(f)
    got = convergence_rehearsal.analyze(artifact)
    for k in ("rel_drift", "eval_deltas", "checks", "ok"):
        assert got[k] == artifact[k], k
    assert "jax_converged" in got["checks"] and "port_converged" not in got["checks"]


def test_recheck_writes_out_and_leaves_its_input(tmp_path, capsys):
    src = tmp_path / "r4.json"
    shutil.copy(R4, src)
    before = src.read_bytes()
    out = tmp_path / "rechecked.json"
    res = convergence_rehearsal.main(["--recheck", str(src), "--out", str(out)])
    assert src.read_bytes() == before
    written = json.loads(out.read_text())
    assert written["checks"] == res["checks"] and written["ok"] is True
    assert written["jax_losses"] == json.loads(before)["jax_losses"]
    with pytest.raises(ValueError, match="never over its input"):
        convergence_rehearsal.main(["--recheck", str(src), "--out", str(src)])
    assert not convergence_rehearsal.DEFAULT_OUT.startswith("benchmarks")


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    out = tmp_path_factory.mktemp("rehearsal") / "r.json"
    res = convergence_rehearsal.main(
        ["--epochs", "2", "--images", "32", "--base-images", "8", "--base", "8",
         "--target-size", "32", "--device", "cpu", "--out", str(out)])
    return res, out


def test_two_epoch_rehearsal_first_step(rehearsal):
    res, out = rehearsal
    t, p = res["torch_losses"][0], res["port_losses"][0]
    assert abs(t - p) <= 1e-5 * abs(t)
    assert res["checks"]["first_step_rel_lt_1e-3"]
    assert res["checks"]["first_epoch_rel_lt_5e-2"]
    assert "port_converged" in res["checks"]
    assert len(res["torch_losses"]) == len(res["port_losses"]) == 2 * 32 // 8
    assert len(res["torch_evals"]) == len(res["port_evals"]) == 2
    assert json.loads(out.read_text())["port_losses"] == res["port_losses"]


def test_rehearsal_cli_exits_non_zero_on_a_failed_check(rehearsal, tmp_path):
    res, out = rehearsal
    assert not res["ok"]  # 2 epochs do not converge
    proc = subprocess.run(
        [sys.executable, "-m", "image_segmentation_tpu_torch.studies.convergence_rehearsal",
         "--recheck", str(out), "--out", str(tmp_path / "again.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert json.loads((tmp_path / "again.json").read_text())["ok"] is False


@pytest.mark.parametrize("module", [bn_regime, convergence_rehearsal])
def test_rehearsals_default_to_the_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main([])
