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

from image_segmentation_tpu.models.clip_unet import ClipUNet as JaxClipUNet
from image_segmentation_tpu.models.clip_vit import ClipViTConfig as JaxViTConfig
from image_segmentation_tpu.serve import engine as jax_engine
from image_segmentation_tpu.ops import geometry as JG
from image_segmentation_tpu_torch.data.labels import COLOR_MAP, colorize_mask
from image_segmentation_tpu_torch.models.clip_unet import ClipUNet
from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.serve import app, engine as port_engine

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT = dict(image_size=64, patch_size=16, hidden_size=128, num_layers=3,
           num_heads=2, mlp_dim=256)
UNET = dict(num_classes=4, skip_indices=(0, 1, 2, 3),
            decoder_channels=(64, 32, 16, 8, 8))


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


def _png_b64(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _decode_png_b64(data):
    from PIL import Image

    with Image.open(io.BytesIO(base64.b64decode(data))) as im:
        return np.asarray(im)


@pytest.mark.parametrize("fast_transfer", [True, False])
@pytest.mark.parametrize("hw", [(50, 70), (400, 1)])
def test_segment_matches_jax_engine(weights, fast_transfer, hw):
    """Masks agree except at near-ties of the JAX engine's restored scores:
    a top-two gap below 1e-4 with f32 transfer, below one bf16 step of
    the scores with bf16 transfer (both engines round scores to bf16)."""
    model, variables, port = weights
    j_eng = jax_engine.InferenceEngine(fast_transfer=fast_transfer)
    j_eng.register("clip", model, variables, 64)
    p_eng = port_engine.InferenceEngine(device="cpu", fast_transfer=fast_transfer)
    p_eng.register("clip", port, 64)
    img = np.random.default_rng(sum(hw)).uniform(0, 1, hw + (3,)).astype(np.float32)

    got = p_eng.segment(img, "clip")
    want = j_eng.segment(img, "clip")
    assert got["mask"].shape == hw and got["class_names"] == want["class_names"]

    entry = j_eng.models["clip"]
    inputs, meta = jax_engine.stage_request(img, entry, None, fast_transfer)
    scores = np.asarray(entry.forward(*[x[None] for x in inputs]), np.float32)[0]
    restored = np.sort(JG.invert_resize_padding_np(scores, meta), axis=-1)
    gap = restored[..., -1] - restored[..., -2]
    tol = 2.0**-7 * np.abs(scores).max() if fast_transfer else 1e-4
    differ = got["mask"] != want["mask"]
    near_ties = int((gap < tol).sum())
    print(f"{hw} fast_transfer={fast_transfer}: {int(differ.sum())} differing "
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
            assert json.load(r) == {"models": ["clip"]}
        img = np.random.default_rng(3).integers(0, 255, (30, 20, 3), dtype=np.uint8)
        req = urllib.request.Request(
            base + "/segment", method="POST",
            data=json.dumps({"model": "clip", "image": _png_b64(img)}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.load(r)
        assert _decode_png_b64(out["output_mask"]).shape == (30, 20, 3)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter (this
    one has jax already), pulls in neither jax nor the JAX package."""
    code = (
        "import pkgutil, sys, importlib, image_segmentation_tpu_torch as p\n"
        "import image_segmentation_tpu_torch.serve.app\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'image_segmentation_tpu' or m.startswith('image_segmentation_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
