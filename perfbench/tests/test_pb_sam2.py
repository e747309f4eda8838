"""The SAM 2.1 Hiera-B+ cell's files on the CPU: its reference and builder
load without JAX or either package, and the builder's counts (parameters,
K5's 19 calls a forward without tables at head dim 56, the FLOPs) are the
configuration's."""
import os
import subprocess
import sys

from perfbench import counts, harness

CELL = "sam2_hiera_bplus_train_clicks_b64"


def test_reference_and_builder_load_nothing_forbidden():
    code = """
import sys
sys.path.insert(0, {root!r})
from perfbench import harness
import perfbench.reference.sam2
cell = harness.load_cell({cell!r})
cell.builder.reference(cell.cfg)
cell.builder.k5_bound_s(cell.cfg, 8)
print("found:" + ",".join(sorted(m for m in sys.modules
                                 if m.split(".")[0] in harness.FORBIDDEN
                                 + ("image_segmentation_tpu_torch",))))
""".format(root=harness.ROOT, cell=CELL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "found:"


def test_builder_counts_are_the_configurations():
    cell = harness.load_cell(CELL)
    cfg, b = cell.cfg, cell.builder
    assert cfg["backbone_channel_list"] == b.channel_list(cfg) == [896, 448, 224, 112]
    ref = b.reference(cfg)
    assert sum(p.numel() for p in ref.parameters()) == cfg["parameters"]
    for n in (1, 8):
        calls = b.k5_calls(cfg, n)
        assert len(calls) == 19 and {d for *_, d in calls} == {56}
        assert sum(tokens for tokens, keys, *_ in calls if keys == 4096) == 3 * n * 4096
    flops, nbytes = b.k5_counts(8 * 65536, 64, 2, 56)
    assert (flops, nbytes) == (4 * 8 * 65536 * 64 * 2 * 56, 2 * 4 * 8 * 65536 * 2 * 56)
    assert counts.bound_s(flops, nbytes)[1] == "bytes"
    bound = b.k5_bound_s(cfg, 8)
    assert 1.3e-3 < bound < 1.6e-3  # seconds a forward at micro-batch 8
    assert abs(b.encoder_flops(cfg) / 1e9 - 645.1) < 0.5
    assert os.path.exists(os.path.join(harness.ROOT, "perfbench", "configs",
                                       cfg["builder"] + ".py"))
