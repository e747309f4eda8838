"""The port's serving path: `segment()` against the JAX engine with the
same weights, the /segment handler and HTTP server, and the rule that
the port never imports jax."""
import base64
import io
import json
import os
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.models import UNet as JaxUNet
from image_segmentation_tpu.models.clip_unet import ClipUNet as JaxClipUNet
from image_segmentation_tpu.models.clip_vit import ClipViTConfig as JaxViTConfig
from image_segmentation_tpu.serve import engine as jax_engine
from image_segmentation_tpu.ops import geometry as JG
from image_segmentation_tpu_torch.config import UNET_NOAUG, build_model
from image_segmentation_tpu_torch.data.labels import COLOR_MAP, colorize_mask
from image_segmentation_tpu_torch.models.clip_unet import ClipUNet
from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.serve import app, engine as port_engine

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = dict(image_size=64, patch_size=16, hidden_size=128, num_layers=3,
           num_heads=2, mlp_dim=256)
UNET = dict(num_classes=4, skip_indices=(0, 1, 2, 3),
            decoder_channels=(64, 32, 16, 8, 8))
FAMILIES = ["autoencoder", "clip", "prompt_model", "unet"]


@pytest.fixture(scope="module")
def weights():
    """A JAX ClipUNet (f32, as the JAX serving registry builds it) and
    the port's ClipUNet carrying the same weights and running stats."""
    model = JaxClipUNet(vit=JaxViTConfig(**VIT), **UNET)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(0)
    v = {"params": jax.tree_util.tree_map(
             lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), v["params"]),
         "batch_stats": jax.tree_util.tree_map(
             lambda a: (a + rng.uniform(0.0, 0.5, a.shape)).astype(np.float32),
             v["batch_stats"])}
    port = ClipUNet(vit=ClipViTConfig(**VIT), **UNET)
    port.load_state_dict(from_jax_variables(v), strict=True)
    return model, v, port.to(memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def unet_weights():
    """A JAX UNet(base=8) (f32, as the JAX demo registry builds it) and the
    port's UNet on its fused path (plain K1 on the CPU) carrying the same
    weights and perturbed running stats."""
    model = JaxUNet(num_classes=4, base=8)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(1)
    v = {"params": jax.tree_util.tree_map(
             lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), v["params"]),
         "batch_stats": jax.tree_util.tree_map(
             lambda a: (a + rng.uniform(0.0, 0.5, a.shape)).astype(np.float32),
             v["batch_stats"])}
    port = UNet(base=8, use_kernels=True)
    port.load_state_dict(from_jax_variables(v), strict=True)
    return model, v, port.to(memory_format=torch.channels_last).eval()


def _png_b64(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _decode_png_b64(data):
    from PIL import Image

    with Image.open(io.BytesIO(base64.b64decode(data))) as im:
        return np.asarray(im)


@pytest.mark.parametrize("family", ["clip", "unet"])
@pytest.mark.parametrize("fast_transfer", [True, False])
@pytest.mark.parametrize("hw", [(50, 70), (400, 1)])
def test_segment_matches_jax_engine(request, family, fast_transfer, hw):
    """Masks agree except at near-ties of the JAX engine's restored scores:
    a top-two gap below 1e-4 with f32 transfer, below one bf16 step of
    the scores with bf16 transfer (both engines round scores to bf16)."""
    model, variables, port = request.getfixturevalue(
        "weights" if family == "clip" else "unet_weights")
    j_eng = jax_engine.InferenceEngine(fast_transfer=fast_transfer)
    j_eng.register(family, model, variables, 64)
    p_eng = port_engine.InferenceEngine(device="cpu", fast_transfer=fast_transfer)
    p_eng.register(family, port, 64)
    img = np.random.default_rng(sum(hw)).uniform(0, 1, hw + (3,)).astype(np.float32)

    got = p_eng.segment(img, family)
    want = j_eng.segment(img, family)
    assert got["mask"].shape == hw and got["class_names"] == want["class_names"]

    entry = j_eng.models[family]
    inputs, meta = jax_engine.stage_request(img, entry, None, fast_transfer)
    scores = np.asarray(entry.forward(*[x[None] for x in inputs]), np.float32)[0]
    restored = np.sort(JG.invert_resize_padding_np(scores, meta), axis=-1)
    gap = restored[..., -1] - restored[..., -2]
    tol = 2.0**-7 * np.abs(scores).max() if fast_transfer else 1e-4
    differ = got["mask"] != want["mask"]
    near_ties = int((gap < tol).sum())
    print(f"{family} {hw} fast_transfer={fast_transfer}: {int(differ.sum())} differing "
          f"pixels, {near_ties} near-ties of {differ.size}")
    assert not np.any(differ & (gap >= tol))


def test_handle_segment_round_trip(weights):
    _, _, port = weights
    eng = port_engine.InferenceEngine(device="cpu")
    eng.register("clip", port, 64)
    arr = np.random.default_rng(1).integers(0, 255, (40, 60, 3), dtype=np.uint8)
    label = np.random.default_rng(2).choice([0, 1, 2, 255], (40, 60)).astype(np.uint8)
    out = app.handle_segment(eng, {"model": "clip", "image": _png_b64(arr),
                                   "label": _png_b64(label)})
    mask_rgb = _decode_png_b64(out["output_mask"])
    want = eng.segment(arr.astype(np.float32) / 255.0, "clip")
    np.testing.assert_array_equal(mask_rgb, want["color_mask"])
    assert set(map(tuple, mask_rgb.reshape(-1, 3))) <= set(map(tuple, COLOR_MAP))
    np.testing.assert_array_equal(_decode_png_b64(out["output_label"]),
                                  colorize_mask(np.where(label == 255, 3, label)))
    assert out["class_names"] == ["background", "cat", "dog", "boundary"]


def test_handle_segment_errors(weights):
    _, _, port = weights
    eng = port_engine.InferenceEngine(device="cpu")
    eng.register("clip", port, 64)
    assert "could not decode image" in app.handle_segment(
        eng, {"model": "clip", "image": base64.b64encode(b"not an image").decode()})["error"]
    assert app.handle_segment(eng, {"image": "x"})["error"] == "missing 'model'"
    bad = app.handle_segment(eng, {"model": "unet", "image": "x"})
    assert bad["available"] == ["clip"]
    assert app.handle_segment(eng, {"model": "clip"})["error"] == "missing 'image'"
    with pytest.raises(KeyError):
        eng.segment(np.zeros((4, 4, 3), np.float32), "unet")


def test_demo_server_over_http():
    eng = app.build_demo_engine("cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), app.make_handler(eng))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/models", timeout=30) as r:
            assert json.load(r) == {"models": FAMILIES}
        img = np.random.default_rng(3).integers(0, 255, (30, 20, 3), dtype=np.uint8)
        for family in FAMILIES:
            body = {"model": family, "image": _png_b64(img)}
            if family == "prompt_model":
                body.update(prompt_type="points", prompt_data=[{"x": 10, "y": 12}])
            req = urllib.request.Request(
                base + "/segment", method="POST", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                out = json.load(r)
            assert _decode_png_b64(out["output_mask"]).shape == (30, 20, 3)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_demo_registry_unet_is_the_jax_demo_unet():
    """The demo's unet family is the JAX demo registry's (app.py:120):
    UNet(base=8), 4 classes, target 64, seeded weights, f32 with the plain
    versions on the CPU; masks come back at the upload's resolution."""
    eng = app.build_demo_engine("cpu")
    assert eng.available() == FAMILIES and eng.models["unet"].target_size == 64
    ref = port_engine.InferenceEngine(device="cpu")
    ref.register("unet", build_model(UNET_NOAUG, "cpu", torch.Generator().manual_seed(0),
                                     base=8), 64)
    img = np.random.default_rng(4).uniform(0, 1, (48, 80, 3))
    out = eng.segment(img, "unet")
    assert out["mask"].shape == (48, 80) and out["mask"].max() <= 3
    np.testing.assert_array_equal(out["mask"], ref.segment(img, "unet")["mask"])


def test_demo_registry_is_the_jax_demo_registry():
    """The port's --demo serves the JAX demo registry's four families
    (app.py:99-168), each at 64 px, the prompt family composed."""
    from image_segmentation_tpu.serve.app import demo_model_specs as jax_demo_specs

    jax_specs = {name: (tsize, needs_prompt)
                 for name, _, _, tsize, needs_prompt in jax_demo_specs()}
    eng = app.build_demo_engine("cpu")
    assert eng.available() == sorted(jax_specs) == FAMILIES
    for name, (tsize, needs_prompt) in jax_specs.items():
        entry = eng.models[name]
        assert (entry.target_size, entry.needs_prompt) == (tsize, needs_prompt)
    assert eng.models["prompt_model"].score_cache is not None


@pytest.fixture(scope="module")
def demo_engine():
    return app.build_demo_engine("cpu")


def _scribble_data_url():
    strokes = np.zeros((64, 64), np.uint8)
    strokes[20:26, 8:56] = 255
    return "data:image/png;base64," + _png_b64(strokes)


@pytest.mark.parametrize("ptype,pdata", [
    ("points", [{"x": 30, "y": 30}, {"x": 5, "y": 60}]),
    ("bbox", {"x": 10, "y": 12, "width": 30, "height": 24}),
    ("scribble", "scribble"),
    ("text", "a cat"),
])
def test_handle_segment_with_prompts(demo_engine, ptype, pdata):
    """Each prompt type, as the frontend sends it, gives the mask that
    segment() gives with the heatmap the renderer makes of it."""
    from image_segmentation_tpu_torch.serve.render import create_prompt_mask

    arr = np.random.default_rng(5).integers(0, 255, (64, 64, 3), dtype=np.uint8)
    if pdata == "scribble":
        pdata = _scribble_data_url()
    out = app.handle_segment(demo_engine, {"model": "prompt_model", "image": _png_b64(arr),
                                           "prompt_type": ptype, "prompt_data": pdata})
    assert out["class_names"] == ["deactivated", "background", "cat", "dog"]
    data = app.decode_base64_gray(pdata) if ptype == "scribble" else pdata
    img = arr.astype(np.float32) / 255.0
    want = demo_engine.segment(img, "prompt_model", create_prompt_mask(ptype, data, (64, 64)))
    np.testing.assert_array_equal(_decode_png_b64(out["output_mask"]), want["color_mask"])


def test_malformed_prompt_data_is_a_client_error(demo_engine):
    """A bbox without prompt_data, a bbox without its fields and an
    undecodable scribble are validation errors (400), not server faults."""
    img = _png_b64(np.zeros((16, 16, 3), np.uint8))
    for ptype, pdata in (("bbox", None), ("bbox", {"x": 1}), ("points", [{"y": 2}])):
        out = app.handle_segment(demo_engine, {"model": "prompt_model", "image": img,
                                               "prompt_type": ptype, "prompt_data": pdata})
        assert "error" in out and "prompt_data" in out["error"], out
    out = app.handle_segment(demo_engine, {"model": "prompt_model", "image": img,
                                           "prompt_type": "scribble", "prompt_data": "!!"})
    assert "could not decode scribble" in out["error"]


class _NoServer:
    """Stands in for the HTTP server: main() must never start serving."""

    def __init__(self, address, handler):
        self.address = address

    def serve_forever(self):
        raise AssertionError("main() started serving")


def test_main_without_cuda_exits_non_zero(monkeypatch):
    """--device defaults to cuda; with no CUDA device the server refuses to
    start (no quiet CPU fallback) and says how to choose the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(app, "ThreadingHTTPServer", _NoServer)
    for argv in (["--demo"], ["--demo", "--device", "cuda:0", "--max-batch", "4"]):
        with pytest.raises(SystemExit) as e:
            app.main(argv)
        assert e.value.code not in (0, None) and "--device cpu" in str(e.value.code)


@pytest.mark.parametrize("build", [lambda: port_engine.InferenceEngine(),
                                   lambda: app.build_demo_engine()],
                         ids=["InferenceEngine", "build_demo_engine"])
def test_engine_defaults_to_the_card(build):
    """With no device argument the engine serves on CUDA; on a machine
    without a card it raises and says how to choose the CPU, rather than
    serving there quietly."""
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        build()


def test_main_on_the_cpu_builds_a_warm_batching_engine(monkeypatch):
    """--device cpu --max-batch 2: the four families behind a warmed-up
    BatchingEngine, handed to the HTTP handler."""
    from image_segmentation_tpu_torch.serve.batching import BatchingEngine

    served = []

    class _Server(_NoServer):
        def serve_forever(self):
            served.append(self.address)

    engines = []
    monkeypatch.setattr(app, "ThreadingHTTPServer", _Server)
    monkeypatch.setattr(app, "make_handler", lambda eng: engines.append(eng))
    app.main(["--demo", "--device", "cpu", "--max-batch", "2", "--port", "0"])
    (eng,) = engines
    try:
        assert isinstance(eng, BatchingEngine) and eng.max_batch == 2
        assert eng.available() == FAMILIES and served == [("127.0.0.1", 0)]
        assert eng.engine.device == torch.device("cpu")
    finally:
        eng.close()


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter (this
    one has jax already), pulls in neither jax nor the JAX package; nor
    does loading the host libraries."""
    code = (
        "import pkgutil, sys, importlib, image_segmentation_tpu_torch as p\n"
        "import image_segmentation_tpu_torch.serve.app\n"
        "import image_segmentation_tpu_torch.ops.augment, image_segmentation_tpu_torch.run\n"
        "import image_segmentation_tpu_torch.data.augment\n"
        "import image_segmentation_tpu_torch.train.feature_cache\n"
        "import image_segmentation_tpu_torch.data.prompts\n"
        "import image_segmentation_tpu_torch.utils.convert_clip_weights\n"
        "import image_segmentation_tpu_torch.parallel.tp, image_segmentation_tpu_torch.parallel.sp\n"
        "import image_segmentation_tpu_torch.parallel.pp\n"
        "import image_segmentation_tpu_torch.parallel.dryrun\n"
        "from image_segmentation_tpu_torch.data import native_pipeline\n"
        "from image_segmentation_tpu_torch.ops import native, native_codec\n"
        "native.available(), native_codec.available()\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'image_segmentation_tpu' or m.startswith('image_segmentation_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
