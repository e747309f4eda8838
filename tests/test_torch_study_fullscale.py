"""The port's converged-run script (`scripts/fullscale.py`) end to end on
the CPU at `--images 12 --epochs 1 --target-size 32 --device cpu`, sweeping
2 families: the JSON it writes has the keys of the JAX
repository's scripts/fullscale_r5.py (read from its source) but for its
one stated divergence, no `chunk_dispatch`; it resumes from its
table.json and writes into its workdir by default."""
import json
import os

import torch

from image_segmentation_tpu_torch.scripts import fullscale
from test_torch_study_pipeline import (  # noqa: F401 (drop_tmp_path is autouse)
    SMALL,
    _check_table,
    drop_tmp_path,
    jax_out_keys,
)

torch.set_num_threads(1)


def test_fullscale_writes_jax_keys_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    work = tmp_path / "w"
    argv = [*SMALL, "--workdir", str(work), "--patience", "0",
            "--sweep-families", "blur,pixelate"]
    out = fullscale.main(argv)
    with open(work / "fullscale.json") as f:
        saved = json.load(f)
    keys, config = jax_out_keys("scripts/fullscale_r5.py")
    # the chunk-dispatch record is left out: the port's loop does not chunk
    assert "chunk_dispatch" in keys and "chunk_dispatch" not in saved
    assert set(saved) == keys - {"chunk_dispatch"} and set(saved["config"]) == config
    _check_table(saved["table"])
    assert set(saved["robustness_curves"]["unet_aug"]) == {"blur", "pixelate"}
    assert all(len(c) == 10 for c in saved["robustness_curves"]["unet_noaug"].values())
    for row in ("unet_aug", "unet_noaug"):
        s = saved["epoch_series"][row]
        assert len(s["epoch_time_s"]) == len(s["val_miou"]) == 1
    assert not saved["config"]["resumed_training"] and out["train_wall_s"] > 0
    # a second call reuses the trained rows and sweeps again
    again = fullscale.main(argv + ["--skip-robustness", "--out", str(tmp_path / "o.json")])
    assert again["config"]["resumed_training"] and again["table"] == saved["table"]
    assert again["robustness_curves"] == {}
    # nothing outside the workdir and --out
    assert sorted(os.listdir(tmp_path)) == ["o.json", "w"]
