"""The port's one-command reference table (`scripts/reproduce_reference.py`)
held against the JAX repository's script.

* `REFERENCE_TABLE`, `ROW_ORDER` and `format_table`'s output equal JAX's
  (read from JAX's script, whose top level imports no jax).
* One row's Test score: a full-width `unet_noaug` UNet with JAX's
  initialiser's weights (BN statistics moved off 0 and 1) saved by each
  package, then `run.main([... --evaluate CKPT --split Test])` of each on
  the same prepared pseudo-Pet tree: acc, dice and iou within 1e-4.
* All six rows end to end at `--epochs 1 --batch-size 2 --target-size 32
  --device cpu` (JAX's test_reproduce_reference_all_rows): finite metrics,
  0 <= iou <= dice <= 1, the chained checkpoints on disk, the table and
  its JSON; `--rows prompt` alone returns {} with a pointer."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu import config as jax_config
from image_segmentation_tpu import run as jax_run
from image_segmentation_tpu.train import checkpoint as jax_ckpt
from image_segmentation_tpu_torch import run
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.scripts import reproduce_reference as repro
from image_segmentation_tpu_torch.studies.robustness_pipeline import prepare_tree
from image_segmentation_tpu_torch.train import checkpoint as ckpt
from test_torch_study_prepare import load_jax_file

torch.set_num_threads(1)

SMALL = ["--epochs", "1", "--batch-size", "2", "--target-size", "32", "--device", "cpu"]


@pytest.fixture(autouse=True)
def drop_tmp_path(tmp_path):
    """Each test's runs hold full-width UNet-64 checkpoints (about 0.9 GB a
    row); they go when the test ends, not with pytest's kept directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_repro():
    return load_jax_file("scripts/reproduce_reference.py", "jax_reproduce_reference")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A prepared pseudo-Pet tree of 16 images: 12 Train, 2 Val, 2 Test."""
    return prepare_tree(str(tmp_path_factory.mktemp("pet")), 16)


def test_reference_table_and_row_order_equal_jax(jax_repro):
    assert repro.REFERENCE_TABLE == jax_repro.REFERENCE_TABLE
    assert repro.ROW_ORDER == jax_repro.ROW_ORDER


@pytest.mark.parametrize("rows,smoke", [(("unet_aug", "prompt", "autoencoder"), True),
                                        (tuple(repro.ROW_ORDER), False),
                                        (("clip_noaug",), True)])
def test_format_table_equals_jax(jax_repro, rows, smoke):
    rng = np.random.default_rng(len(rows))
    results = {r: {k: float(v) for k, v in zip(("acc", "dice", "iou", "loss"),
                                               rng.uniform(0, 1, 4))} for r in rows}
    assert repro.format_table(results, smoke) == jax_repro.format_table(results, smoke)


def test_unet_noaug_test_score_matches_jax(tree, tmp_path):
    cfg = jax_config.CONFIGS["unet_noaug"]
    model = jax_config.build_model(cfg, on_tpu=False)
    variables = model.init(jax.random.PRNGKey(5), jnp.zeros((1, 32, 32, 3)), train=False)
    rng = np.random.default_rng(2)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    jax_ckpt.save_params_only(str(tmp_path / "jax_MO_unet_noaug"), params, stats)
    ckpt.save_params_only(str(tmp_path / "MO_unet_noaug"),
                          from_jax_variables({"params": params, "batch_stats": stats}))
    common = ["--config", "unet_noaug", "--data-root", tree, "--split", "Test",
              "--target-size", "32", "--batch-size", "2", "--max-devices", "1"]
    want = jax_run.main(common + ["--evaluate", str(tmp_path / "jax_MO_unet_noaug")])
    got = run.main(common + ["--evaluate", str(tmp_path / "MO_unet_noaug"), "--device", "cpu"])
    for k in ("acc", "dice", "iou"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-4, (k, got[k], want[k])


def test_all_six_rows_end_to_end(tree, tmp_path, capsys):
    out_json = str(tmp_path / "table.json")
    runs = tmp_path / "runs"
    results = repro.main(["--data-root", tree, "--save-dir", str(runs), *SMALL,
                          "--max-devices", "1", "--json-out", out_json])
    assert set(results) == set(repro.ROW_ORDER)
    for row, m in results.items():
        assert all(np.isfinite(m[k]) for k in ("acc", "dice", "iou", "loss")), (row, m)
        assert 0.0 <= m["iou"] <= m["dice"] <= 1.0, (row, m)
    printed = capsys.readouterr().out
    for row in repro.ROW_ORDER:
        assert repro.REFERENCE_TABLE[row][0] in printed
    assert "smoke ViT" in printed
    with open(out_json) as f:
        payload = json.load(f)
    assert payload["smoke_clip"] is True and set(payload["rows"]) == set(repro.ROW_ORDER)
    # the chained checkpoints: recon_ae consumed by the autoencoder transfer,
    # the augmented ClipUNet consumed by the prompt row
    for d in ("autoencoder/recon_ae", "autoencoder/autoencoder", "clip_aug/clipunet",
              "prompt/prompt", "unet_aug/unet_aug", "unet_noaug/unet_noaug"):
        assert os.path.isfile(runs / d / ckpt.STATE_FILE), d


def test_prompt_row_alone_is_skipped_with_a_pointer(tree, tmp_path, capsys):
    results = repro.main(["--data-root", tree, "--save-dir", str(tmp_path / "runs"), *SMALL,
                          "--rows", "prompt"])
    assert results == {}
    assert "run the clip_aug row first" in capsys.readouterr().out


def test_unknown_row_is_refused(tree, tmp_path):
    with pytest.raises(SystemExit):
        repro.main(["--data-root", tree, "--save-dir", str(tmp_path), *SMALL, "--rows", "vgg"])
