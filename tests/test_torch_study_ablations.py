"""The port's ablation harness (`studies/ablations.py`) against the JAX
repository's benchmarks/ablations.py.

* `hard_synthetic_items` equals JAX's array for array (exact), at the
  default knobs and at the skips ablation's shifted ones.
* `calculate_class_weights`, which the harness's weight schemes call,
  equals JAX's data/labels.py function (exact).
* `loss`, `skips` and `prompt_freeze` run end to end at the CPU sizes (JAX
  ablations.py:232-245; JAX's test_loss_experiment_runs_end_to_end and
  test_skips_and_prompt_freeze_experiments_run_end_to_end): each row's
  Dice and mIoU lie in [0, 1] and each experiment names a winner."""
import json

import numpy as np
import pytest
import torch

from image_segmentation_tpu.data.labels import calculate_class_weights as jax_class_weights
from image_segmentation_tpu_torch.data.labels import calculate_class_weights
from image_segmentation_tpu_torch.studies import ablations
from test_torch_study_prepare import load_jax_file

torch.set_num_threads(1)

SHIFT = dict(obj_lo=6, obj_hi=3, contrast=(0.3, 0.5), noise=0.05, bg=(0.5, 0.1))


@pytest.fixture(scope="module")
def jax_ablations():
    return load_jax_file("benchmarks/ablations.py", "jax_ablations")


@pytest.mark.parametrize("seed,kw", [(0, {}), (50, SHIFT)])
def test_hard_synthetic_items_equal_jax(jax_ablations, seed, kw):
    got = ablations.hard_synthetic_items(6, seed, **kw)
    want = jax_ablations.hard_synthetic_items(6, seed, **kw)
    assert len(got) == len(want) == 6
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    labels = np.concatenate([l.reshape(-1) for _, l in got])
    assert set(np.unique(labels).tolist()) <= {0, 1, 2, 255} and 255 in labels


@pytest.mark.parametrize("kw", [{}, dict(unimportant_class_indices=[3]),
                                dict(ignore_index=3, normalize_target_sum=2.0)])
def test_class_weights_equal_jax(kw):
    rng = np.random.default_rng(4)
    labels = [rng.integers(0, 4, (23, 31)) for _ in range(3)] + [np.full((5, 5), 7)]
    np.testing.assert_array_equal(calculate_class_weights(labels, 4, **kw),
                                  jax_class_weights(labels, 4, **kw))


def _rows(capsys):
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    return ([r for r in rows if "experiment" in r],
            {r["summary"]: r for r in rows if "summary" in r})


def test_loss_experiment_runs_end_to_end(capsys, tmp_path):
    out = ablations.main(["--experiments", "loss", "--device", "cpu",
                          "--out", str(tmp_path / "a.json")])
    runs, summaries = _rows(capsys)
    assert {r["variant"] for r in runs} == {"ce", "dice_ce"}
    for r in runs:
        assert 0.0 <= r["best_dice"] <= 1.0 and 0.0 <= r["best_miou"] <= 1.0
        assert r["steady_epoch_s"] > 0
    assert summaries["loss"]["winner"] in ("ce", "dice_ce")
    # the CPU sizes of JAX ablations.py:232-245
    assert out["config"] == {"images": 16, "epochs": 2, "batch": 8, "base": 8, "target": 64,
                             "clip_pre_epochs": 2, "clip_epochs": 2, "vit_hidden": 128,
                             "vit_layers": 6, "vit_heads": None}
    with open(tmp_path / "a.json") as f:
        assert json.load(f)["rows"] == out["rows"]


def test_skips_and_prompt_freeze_experiments_run_end_to_end(capsys):
    ablations.main(["--experiments", "skips,prompt_freeze", "--device", "cpu"])
    runs, summaries = _rows(capsys)
    assert {(r["experiment"], r["variant"]) for r in runs} == {
        ("skips", "encoder_pretrain(linear-probe,shifted)"), ("skips", "skips"),
        ("skips", "noskips"), ("prompt_freeze", "frozen"), ("prompt_freeze", "finetuned")}
    assert set(summaries) == {"skips", "prompt_freeze"}
    for r in runs:
        assert 0.0 <= r["best_miou"] <= 1.0
