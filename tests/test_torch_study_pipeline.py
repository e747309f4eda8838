"""The port's robustness pipeline end to end on the CPU at `--images 12
--epochs 1 --target-size 32 --device cpu`: the JSON it writes has the keys
of the JAX repository's benchmarks/robustness_pipeline.py (read from its
source), both rows' 8 x 10 curves and a finite clean Test table."""
import ast
import json
import os
import shutil

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.studies import robustness_pipeline
from image_segmentation_tpu_torch.studies.robustness import PERTURBATIONS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--images", "12", "--epochs", "1", "--target-size", "32", "--batch", "2",
         "--device", "cpu"]


@pytest.fixture(autouse=True)
def drop_tmp_path(tmp_path):
    """Each test's runs hold full-width UNet-64 checkpoints (about 0.9 GB a
    row); they go when the test ends, not with pytest's kept directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def jax_out_keys(rel: str) -> tuple:
    """The keys of the `out = {...}` dict a JAX script writes, and of its
    "config" entry."""
    with open(os.path.join(ROOT, rel)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "out" for t in node.targets)):
            keys = [k.value for k in node.value.keys]
            config = node.value.values[keys.index("config")]
            return set(keys), {k.value for k in config.keys}
    raise AssertionError(f"no out dict in {rel}")


def _check_table(table):
    assert set(table) == {"unet_aug", "unet_noaug"}
    for m in table.values():
        assert all(np.isfinite(m[k]) for k in ("acc", "dice", "iou", "loss"))
        assert 0.0 <= m["iou"] <= m["dice"] <= 1.0


def test_robustness_pipeline_writes_jax_keys(tmp_path):
    out_path = tmp_path / "r.json"
    out = robustness_pipeline.main([*SMALL, "--workdir", str(tmp_path / "w"),
                                    "--out", str(out_path)])
    with open(out_path) as f:
        saved = json.load(f)
    keys, config = jax_out_keys("benchmarks/robustness_pipeline.py")
    assert set(saved) == keys and set(saved["config"]) == config
    assert saved["device"] == "cpu"
    _check_table(saved["clean_test"])
    for row in ("unet_aug", "unet_noaug"):
        assert list(saved["curves"][row]) == list(PERTURBATIONS)
        assert all(len(c) == 10 for c in saved["curves"][row].values())
    assert 0 <= saved["perturbations_where_aug_wins"] <= 8
    assert out["wall_s"] > 0
