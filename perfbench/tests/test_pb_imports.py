"""Nothing the benchmark loads brings in JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the port either."""
import ast
import os
import subprocess
import sys

from perfbench import harness

REF = os.path.join(harness.HERE, "reference")


def test_no_jax_after_loading_every_file_of_the_benchmark():
    code = """
import os, sys
sys.path.insert(0, {root!r})
from perfbench import harness, tracing, counts
import perfbench.reference.unet, perfbench.reference.clip, perfbench.reference.train
for w in [c["name"] for c in harness.read_json(os.path.join({root!r}, "BENCHMARK.json"))["workloads"]]:
    cell = harness.load_cell(w)
    for m in cell.per_layer:
        harness.metric_reader(m["name"])
import image_segmentation_tpu_torch.serve.batching, image_segmentation_tpu_torch.train.steps
import image_segmentation_tpu_torch.train.loop, image_segmentation_tpu_torch.models.clip_unet
print("found:" + ",".join(harness.forbidden_modules()))
""".format(root=harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "found:"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib_helper", sys)
    monkeypatch.setitem(sys.modules, "image_segmentation_tpu_torch_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert harness.forbidden_modules() == ["flax.linen"]


def test_reference_imports_neither_jax_nor_either_package():
    banned = {"jax", "jaxlib", "flax", "image_segmentation_tpu", "image_segmentation_tpu_torch"}
    for name in os.listdir(REF):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REF, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not banned & set(tops), (name, tops)
