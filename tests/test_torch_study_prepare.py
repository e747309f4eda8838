"""The port's Pet preparation and pseudo-Pet source held against the JAX
repository's scripts, and the import rule of the study modules.

`scripts/prepare_oxford_pet.py` (loaded from its file, as
tests/test_real_data_fixture.py loads it) and the port's
`scripts.prepare_oxford_pet` convert one pseudo-Pet download: the two trees
list the same files, the photos are byte-equal and the label PNGs decode to
equal arrays. `make_pet_source` of both packages writes, for one `n` and
seed, JPEGs and trimaps that decode to equal arrays and an equal list.txt.
Every comparison here is exact."""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from image_segmentation_tpu_torch.scripts import prepare_oxford_pet
from image_segmentation_tpu_torch.studies import robustness_pipeline

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 10


def load_jax_file(rel: str, name: str):
    """A JAX repository script or benchmark module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _decoded(path):
    with Image.open(path) as im:
        return np.asarray(im)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The same source written by each package's make_pet_source."""
    base = tmp_path_factory.mktemp("pet")
    jax_rp = load_jax_file("benchmarks/robustness_pipeline.py", "jax_robustness_pipeline")
    jax_rp.make_pet_source(str(base / "jax_src"), N, seed=3)
    robustness_pipeline.make_pet_source(str(base / "port_src"), N, seed=3)
    return base


def test_make_pet_source_writes_jax_tree(sources):
    js, ps = sources / "jax_src", sources / "port_src"
    assert _files(js) == _files(ps) and len(_files(ps)) == 2 * N + 1
    for rel in _files(js):
        if rel.endswith("list.txt"):
            assert (js / rel).read_text() == (ps / rel).read_text()
        else:
            np.testing.assert_array_equal(_decoded(js / rel), _decoded(ps / rel), err_msg=rel)


@pytest.mark.parametrize("split_args", [[], ["--val", "0.15", "--test", "0.15", "--seed", "4"]])
def test_prepare_matches_jax_script(sources, tmp_path, split_args):
    src = str(sources / "port_src")
    jax_prep = load_jax_file("scripts/prepare_oxford_pet.py", "jax_prepare_oxford_pet")
    jax_prep.main(["--src", src, "--dst", str(tmp_path / "jax"), *split_args])
    splits = prepare_oxford_pet.main(["--src", src, "--dst", str(tmp_path / "port"),
                                      *split_args])
    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port")
    assert sum(map(len, splits.values())) == N and len(files) == 2 * N
    for rel in files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.endswith(".jpg"):
            assert a.read_bytes() == b.read_bytes(), rel
        else:
            lab = _decoded(b)
            np.testing.assert_array_equal(_decoded(a), lab, err_msg=rel)
            assert set(np.unique(lab).tolist()) <= {0, 1, 2, 255}


@pytest.mark.parametrize("trimap,species", [(np.array([[1, 2, 3]], np.uint8), 1),
                                            (np.array([[3, 1], [2, 1]], np.uint8), 2)])
def test_trimap_to_classes_and_species(trimap, species):
    jax_prep = load_jax_file("scripts/prepare_oxford_pet.py", "jax_prepare_oxford_pet")
    np.testing.assert_array_equal(prepare_oxford_pet.trimap_to_classes(trimap, species),
                                  jax_prep.trimap_to_classes(trimap, species))
    for stem in ("Abyssinian_1", "beagle_2", ""):
        assert prepare_oxford_pet.species_from_name(stem) == jax_prep.species_from_name(stem)


def test_prepare_refuses_a_tree_without_trimaps(tmp_path):
    (tmp_path / "images").mkdir()
    with pytest.raises(SystemExit):
        prepare_oxford_pet.main(["--src", str(tmp_path), "--dst", str(tmp_path / "out")])


STUDY_MODULES = ("scripts.prepare_oxford_pet", "scripts.reproduce_reference",
                 "scripts.fullscale", "studies.robustness", "studies.robustness_pipeline",
                 "studies.ablations")


def test_study_modules_import_no_jax():
    mods = ", ".join(f"image_segmentation_tpu_torch.{m}" for m in STUDY_MODULES)
    code = (f"import sys, {mods}; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'image_segmentation_tpu.', 'benchmarks', 'scripts')) "
            "or m == 'image_segmentation_tpu']; assert not bad, bad")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr


@pytest.mark.parametrize("module", ["scripts.fullscale", "studies.robustness",
                                    "studies.robustness_pipeline", "studies.ablations"])
def test_study_cli_needs_a_card_unless_told_cpu(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", f"image_segmentation_tpu_torch.{module}"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "no CUDA device" in p.stderr
