"""The port's AOT export (serve/export.py): the serving forward traced by
torch.export into one program with the weights in it, served back with
no model code. The cases of tests/test_export.py on the port (scores equal
the live engine's, the symbolic batch, the prompt model's two inputs, the
dtype adapter, the version check, the registry CLI); then what is the
port's own: the program holds K1/K3/K4 as `istpu::` ops, a fresh process
serves it without the port's models or jax, a program is refused on
another device type, and its scores equal the JAX package's exported
program's on the same weights."""
import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.models import UNet as JaxUNet
from image_segmentation_tpu.serve import export as jax_export
from image_segmentation_tpu_torch.models.clip_unet import ClipUNet
from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.prompt import PromptModel
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.serve.engine import InferenceEngine
from image_segmentation_tpu_torch.serve.export import (
    ARTIFACT_EXT,
    export_model,
    export_registry,
    load_exported,
    save_exported,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = ("background", "cat", "dog", "boundary")
PROMPT = ("deactivated", "background", "cat", "dog")


def _seeded(model, seed=0):
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def tiny_unet():
    return _seeded(UNet(base=4))


@pytest.fixture(scope="module")
def tiny_prompt():
    # 4 up blocks (one per skip) climb the 16x patch stride back to 32 px,
    # the geometry of tests/test_export.py
    vit = ClipViTConfig(image_size=32, patch_size=16, hidden_size=32, num_layers=4,
                        num_heads=2, mlp_dim=64)
    return _seeded(PromptModel(vit=vit, skip_indices=(1, 2, 3, 4),
                               decoder_channels=(32, 16, 8, 8, 8), unet_base=4))


def _img(hw, seed):
    return np.random.default_rng(seed).uniform(0, 1, hw + (3,)).astype(np.float32)


def test_scores_match_live_engine(tiny_unet, tmp_path):
    path = str(tmp_path / f"unet{ARTIFACT_EXT}")
    meta = save_exported(path, tiny_unet, 32, name="unet", class_names=SEG)
    assert meta["device_type"] == "cpu" and meta["input_dtype"] == "uint8"
    assert meta["output_dtype"] == "bfloat16" and meta["torch_version"] == torch.__version__
    live = InferenceEngine("cpu")
    live.register("unet", tiny_unet, 32)
    aot = InferenceEngine("cpu")
    assert aot.register_exported(path) == "unet"
    assert aot.models["unet"].target_size == 32 and aot.models["unet"].class_names == SEG
    img = _img((40, 28), 0)
    a, b = live.segment(img, "unet"), aot.segment(img, "unet")
    np.testing.assert_array_equal(a["mask"], b["mask"])
    np.testing.assert_array_equal(a["color_mask"], b["color_mask"])


def test_symbolic_batch(tiny_unet, tmp_path):
    """One program serves every batch size (BatchingEngine buckets too)."""
    path = str(tmp_path / f"unet{ARTIFACT_EXT}")
    save_exported(path, tiny_unet, 32, name="unet", class_names=SEG)
    call, _ = load_exported(path, "cpu")
    rng = np.random.default_rng(1)
    for b in (1, 3, 5):
        out = call(rng.integers(0, 255, (b, 32, 32, 3)).astype(np.uint8))
        assert out.shape == (b, 32, 32, 4) and out.dtype == torch.bfloat16
        assert torch.isfinite(out.float()).all()


def test_prompt_model_two_inputs(tiny_prompt, tmp_path):
    """The program is the monolithic prompt forward; the live engine's is
    composed (a cached clip branch): the same masks."""
    path = str(tmp_path / f"prompt{ARTIFACT_EXT}")
    save_exported(path, tiny_prompt, 32, name="prompt_model", class_names=PROMPT,
                  needs_prompt=True)
    live = InferenceEngine("cpu")
    live.register_prompt_composed("prompt_model", tiny_prompt, 32)
    aot = InferenceEngine("cpu")
    aot.register_exported(path)
    assert aot.models["prompt_model"].needs_prompt
    img = _img((32, 32), 2)
    pm = np.zeros((32, 32), np.float32)
    pm[10:20, 10:20] = 1.0
    np.testing.assert_array_equal(live.segment(img, "prompt_model", pm)["mask"],
                                  aot.segment(img, "prompt_model", pm)["mask"])


def test_dtype_adapter_bridges_contracts(tiny_unet, tmp_path):
    """A float32 program serves a fast-transfer (uint8) engine and a uint8
    program a float32 one: the loader adapts on the device. Both quantise
    the staged input once; the uint8 program also rounds scores to bf16,
    which can flip a near-tie, hence agreement and not equality (the
    bound of tests/test_export.py)."""
    f32, u8 = str(tmp_path / f"f32{ARTIFACT_EXT}"), str(tmp_path / f"u8{ARTIFACT_EXT}")
    save_exported(f32, tiny_unet, 32, name="unet", class_names=SEG, fast_transfer=False)
    save_exported(u8, tiny_unet, 32, name="unet", class_names=SEG, fast_transfer=True)
    img = _img((32, 32), 3)
    fast = InferenceEngine("cpu", fast_transfer=True)
    fast.register_exported(f32, name="m")
    slow = InferenceEngine("cpu", fast_transfer=False)
    slow.register_exported(u8, name="m")
    assert (fast.segment(img, "m")["mask"] == slow.segment(img, "m")["mask"]).mean() > 0.99


def _rewrite_meta(src, dst, **changes):
    with zipfile.ZipFile(src) as z:
        files = {n: z.read(n) for n in z.namelist()}
    meta = json.loads(files["meta.json"])
    meta.update(changes)
    files["meta.json"] = json.dumps(meta).encode()
    with zipfile.ZipFile(dst, "w") as z:
        for n, data in files.items():
            z.writestr(n, data)


def test_version_mismatch_rejected(tiny_unet, tmp_path):
    path = str(tmp_path / f"unet{ARTIFACT_EXT}")
    save_exported(path, tiny_unet, 32, name="unet", class_names=SEG)
    bad = str(tmp_path / f"bad{ARTIFACT_EXT}")
    _rewrite_meta(path, bad, version=999)
    with pytest.raises(ValueError, match="version"):
        load_exported(bad, "cpu")


def test_device_mismatch_refused(tiny_unet, tmp_path):
    """A program serves the device type it was traced on and no other: a
    CPU program is refused on cuda (before any card is asked for), and one
    marked cuda is refused on the CPU, with no fallback."""
    path = str(tmp_path / f"unet{ARTIFACT_EXT}")
    save_exported(path, tiny_unet, 32, name="unet", class_names=SEG)
    with pytest.raises(ValueError, match="exported on cpu, refused on cuda"):
        load_exported(path, "cuda")
    marked = str(tmp_path / f"cuda{ARTIFACT_EXT}")
    _rewrite_meta(path, marked, device_type="cuda")
    with pytest.raises(ValueError, match="exported on cuda, refused on cpu"):
        InferenceEngine("cpu").register_exported(marked)


def _op_counts(program):
    counts = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("istpu."):
            name = str(node.target).split(".")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


def test_program_holds_the_kernels_as_ops():
    """Traced from models with the kernels on, the program calls K3 and K4
    once per ViT layer and K1 nine times per UNet (five double convs, four
    with the up block's concat), as `istpu::` ops; on the CPU the ops run
    the plain versions, so the program's scores are the model's."""
    vit = ClipViTConfig(image_size=64, patch_size=16, hidden_size=128, num_layers=3,
                        num_heads=2, mlp_dim=256)
    clip = _seeded(ClipUNet(vit=vit, skip_indices=(0, 1, 2, 3),
                            decoder_channels=(64, 32, 16, 8, 8), use_kernels=True))
    unet = _seeded(UNet(base=8, use_kernels=True))
    prompt = _seeded(PromptModel(vit=vit, skip_indices=(0, 1, 2, 3),
                                 decoder_channels=(64, 32, 16, 8, 8), unet_base=8,
                                 use_kernels=True))
    want = {"clip": {"fused_attention": 3, "fused_mlp": 3},
            "unet": {"fused_double_conv": 5, "fused_double_conv_cat": 4},
            "prompt": {"fused_attention": 3, "fused_mlp": 3, "fused_double_conv": 5,
                       "fused_double_conv_cat": 4}}
    rng = np.random.default_rng(4)
    for name, model in (("clip", clip), ("unet", unet), ("prompt", prompt)):
        program, _ = export_model(model, 64, needs_prompt=name == "prompt",
                                  fast_transfer=False)
        assert _op_counts(program) == want[name], name
        xs = [torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, c)).astype(np.float32))
              for c in ((3, 1) if name == "prompt" else (3,))]
        with torch.no_grad():
            np.testing.assert_array_equal(program.module()(*xs).numpy(), model(*xs).numpy())


def test_program_of_the_module_path_holds_no_op(tiny_unet):
    """A UNet with the kernels off (the CPU registry's) traces to the module
    path, and the eager path never dispatches the ops."""
    program, _ = export_model(tiny_unet, 32)
    assert _op_counts(program) == {}


def test_fresh_process_serves_without_model_code(tiny_unet, tmp_path):
    """A new interpreter registers and serves a program: no module of
    image_segmentation_tpu_torch.models, no jax, no JAX package."""
    path = str(tmp_path / f"unet{ARTIFACT_EXT}")
    save_exported(path, tiny_unet, 32, name="unet", class_names=SEG)
    want = InferenceEngine("cpu")
    want.register("unet", tiny_unet, 32)
    img = _img((30, 41), 5)
    np.save(tmp_path / "img.npy", img)
    code = (
        "import sys, numpy as np\n"
        "from image_segmentation_tpu_torch.serve.engine import InferenceEngine\n"
        "eng = InferenceEngine('cpu')\n"
        f"eng.register_exported({path!r})\n"
        f"mask = eng.segment(np.load({str(tmp_path / 'img.npy')!r}), 'unet')['mask']\n"
        f"np.save({str(tmp_path / 'mask.npy')!r}, mask)\n"
        "bad = [m for m in sys.modules if m.startswith('image_segmentation_tpu_torch.models')\n"
        "       or m == 'jax' or m.startswith('jax.') or m == 'image_segmentation_tpu'\n"
        "       or m.startswith('image_segmentation_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "mask.npy"),
                                  want.segment(img, "unet")["mask"])


def test_scores_equal_the_jax_program(tmp_path):
    """JAX's exported program (StableHLO, run on the CPU) and the port's, of
    one tiny UNet's weights, on the same uint8 staged batch: scores within
    one bf16 step of the largest (both programs round scores to bf16)."""
    model = JaxUNet(num_classes=4, base=4)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    rng = np.random.default_rng(6)
    # trained-like weights and statistics (a zero mean stays zero, so the
    # ReLUs keep firing)
    v = {"params": jax.tree_util.tree_map(
             lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), v["params"]),
         "batch_stats": jax.tree_util.tree_map(
             lambda a: (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
             v["batch_stats"])}
    jax_path = str(tmp_path / "unet.istpu")
    jax_export.save_exported(jax_path, model, v, 32, name="unet", class_names=SEG,
                             platforms=("cpu",))
    port = UNet(base=4)
    port.load_state_dict(from_jax_variables(v), strict=True)
    port_path = str(tmp_path / f"unet{ARTIFACT_EXT}")
    save_exported(port_path, port.to(memory_format=torch.channels_last).eval(), 32,
                  name="unet", class_names=SEG)
    x = rng.integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    jax_call, _ = jax_export.load_exported(jax_path)
    want = np.asarray(jax_call(x), np.float32)
    port_call, _ = load_exported(port_path, "cpu")
    got = port_call(x).float().numpy()
    err = float(np.abs(got - want).max())
    print(f"max |port - JAX| = {err:.3g}, one bf16 step of the largest "
          f"{2.0**-7 * np.abs(want).max():.3g}")
    assert err <= 2.0**-7 * np.abs(want).max()


def test_demo_registry_export_and_serve(tmp_path, monkeypatch):
    """The CLI's path over the demo registry on the CPU: four programs,
    served with masks at the upload's size; `only` exports one; nothing
    to export is an error; the default --device cuda without a card exits
    and says how to choose the CPU."""
    from image_segmentation_tpu_torch.serve.export import main

    out = str(tmp_path / "exports")
    written = main(["--demo", "--out", out, "--device", "cpu"])
    assert {os.path.basename(w) for w in written} == {
        f"{n}{ARTIFACT_EXT}" for n in ("unet", "autoencoder", "clip", "prompt_model")}
    eng = InferenceEngine("cpu")
    for w in written:
        eng.register_exported(w)
    assert eng.available() == ["autoencoder", "clip", "prompt_model", "unet"]
    img = _img((50, 70), 7)
    assert eng.segment(img, "unet")["mask"].shape == (50, 70)
    pm = np.zeros((50, 70), np.float32)
    pm[20:30, 30:40] = 1.0
    res = eng.segment(img, "prompt_model", pm)
    assert res["mask"].shape == (50, 70) and res["class_names"][0] == "deactivated"
    one = export_registry("", str(tmp_path / "e1"), demo=True, only="unet", device="cpu")
    assert [os.path.basename(w) for w in one] == [f"unet{ARTIFACT_EXT}"]
    with pytest.raises(SystemExit):
        export_registry("", str(tmp_path / "e2"), demo=True, only="nope", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["--demo", "--out", out])


def test_batching_engine_serves_a_program(tiny_unet, tmp_path):
    """Concurrent requests over a registered program go through the
    BatchingEngine's buckets (the symbolic batch), and each mask is the one
    the program gives the request alone."""
    import threading

    from image_segmentation_tpu_torch.serve.batching import BatchingEngine

    path = str(tmp_path / f"unet{ARTIFACT_EXT}")
    save_exported(path, tiny_unet, 32, name="unet", class_names=SEG)
    eng = InferenceEngine("cpu")
    eng.register_exported(path)
    sizes = []
    real = eng.models["unet"].dispatch

    def counting(*xs):
        sizes.append(xs[0].shape[0])
        return real(*xs)

    eng.models["unet"].dispatch = counting
    imgs = [_img((20 + 3 * i, 30), 10 + i) for i in range(8)]
    want = [eng.segment(im, "unet")["mask"] for im in imgs]
    sizes.clear()
    be = BatchingEngine(eng, max_batch=4, max_wait_ms=50)
    got = [None] * len(imgs)
    try:
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, be.segment(imgs[i], "unet")["mask"])) for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        be.close()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert sum(sizes) >= len(imgs) and max(sizes) > 1, sizes
