"""Mesh serving (serve/engine.py `InferenceEngine(devices=)`, `serve.app
--mesh`, `predict --mesh`): one process over a device list, a replica a
device. As JAX's test_serve.py:465-500 pins its mesh engine to the
single-device one, the engine over [cpu, cpu] is held to the engine on one
CPU: a batch that divides the devices runs in per-device chunks, any
other on the first device, and the scores agree; the four demo families
agree request by request and under request batching; the composed prompt
path falls back to the monolithic model and an exported program runs on
the first device with JAX's note.
"""
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.serve import app
from image_segmentation_tpu_torch.serve.batching import BatchingEngine
from image_segmentation_tpu_torch.serve.engine import InferenceEngine

torch.set_num_threads(1)

CPUS = ["cpu", "cpu"]


def test_mesh_engine_matches_single_device():
    """Batch 8 runs as two chunks of 4, one a replica; batch 3 does not
    divide and runs whole on the first device; the scores equal the
    single-device engine's (atol 2e-5, JAX's bound)."""
    model = UNet(num_classes=4, base=8).init_weights(torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    calls = []
    model.register_forward_hook(lambda m, inp, out: calls.append((id(m), inp[0].shape[0])))
    plain = InferenceEngine("cpu", fast_transfer=False)
    plain.register("unet", model, 32)
    meshed = InferenceEngine(fast_transfer=False, devices=CPUS)
    meshed.register("unet", model, 32)
    rng = np.random.default_rng(0)
    for batch in (8, 3):
        x = rng.uniform(0, 1, (batch, 32, 32, 3)).astype(np.float32)
        want = plain.forward("unet", x)
        calls.clear()
        got = meshed.forward("unet", x)
        np.testing.assert_allclose(got, want, atol=2e-5)
        if batch == 8:  # two replicas, four rows each
            assert [n for _, n in calls] == [4, 4] and calls[0][0] != calls[1][0]
        else:
            assert calls == [(id(model), 3)]


@pytest.fixture(scope="module")
def engines():
    return app.build_demo_engine("cpu"), app.build_demo_engine("cpu", devices=CPUS)


def _images():
    rng = np.random.default_rng(1)
    return [rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for h, w in ((50, 70), (64, 64))]


def test_four_families_agree_with_the_one_device_engine(engines):
    plain, meshed = engines
    assert meshed.available() == plain.available()
    # the prompt family is the monolithic model under a mesh (no score cache)
    assert meshed.models["prompt_model"].score_cache is None
    assert meshed.models["prompt_model"].needs_prompt
    heat = np.zeros((50, 70), np.float32)
    heat[20:30, 30:40] = 1.0
    for name in plain.available():
        for img in _images():
            prompt = heat if name == "prompt_model" and img.shape == (50, 70, 3) else None
            want = plain.segment(img, name, prompt)
            got = meshed.segment(img, name, prompt)
            assert got["class_names"] == want["class_names"]
            assert np.array_equal(got["mask"], want["mask"]), name


def test_batched_requests_split_over_the_mesh(engines):
    """--max-batch 4 on the mesh: each batch of 4 staged requests is two
    chunks of 2, and the scores are the one-device engine's."""
    plain, meshed = engines
    for name in plain.available():
        entry = meshed.models[name]
        t = entry.target_size
        rng = np.random.default_rng(2)
        xs = [rng.uniform(0, 1, (4, t, t, 3)).astype(np.float32)]
        if entry.needs_prompt:
            xs.append(rng.uniform(0, 1, (4, t, t, 1)).astype(np.float32))
        packed = [x if not plain.fast_transfer else
                  np.clip(np.round(x * 255), 0, 255).astype(np.uint8) for x in xs]
        # the scores cross back as bf16 (fast_transfer): one bf16 step apart at most
        np.testing.assert_allclose(meshed.forward(name, *packed), plain.forward(name, *packed),
                                   rtol=2.0**-7, atol=1e-6)
    batching = BatchingEngine(meshed, max_batch=4)
    try:
        img = _images()[0]
        assert np.array_equal(batching.segment(img, "unet")["mask"],
                              plain.segment(img, "unet")["mask"])
    finally:
        batching.close()


def test_exported_program_runs_single_device_with_jax_note(monkeypatch):
    from image_segmentation_tpu_torch.serve import export

    meta = {"name": "unet", "target_size": 32, "class_names": ["a"], "needs_prompt": False}
    monkeypatch.setattr(export, "load_exported", lambda path, device: (lambda x: x, meta))
    eng = InferenceEngine(devices=CPUS)
    out = io.StringIO()
    with redirect_stdout(out):
        eng.register_exported("unet.istpt")
    assert "[serve] note: mesh serving does not apply to AOT artifacts — 'unet' runs " \
           "single-device" in out.getvalue()


def test_serve_app_mesh_flag(monkeypatch):
    """`serve.app --mesh --device cpu` serves over the CPU and says so."""
    built = {}

    class FakeServer:
        def __init__(self, addr, handler):
            built["addr"] = addr

        def serve_forever(self):
            built["served"] = True

    monkeypatch.setattr(app, "ThreadingHTTPServer", FakeServer)
    monkeypatch.setattr(app, "build_demo_engine",
                        lambda device, devices=None: built.setdefault(
                            "engine", InferenceEngine(device, devices=devices)))
    out = io.StringIO()
    with redirect_stdout(out):
        app.main(["--mesh", "--device", "cpu", "--port", "0"])
    assert "[serve] mesh serving over 1 devices" in out.getvalue()
    assert built["served"] and built["engine"].devices == [torch.device("cpu")]


def test_predict_mesh_flag(tmp_path):
    from image_segmentation_tpu_torch.data.png import encode_png
    from image_segmentation_tpu_torch.predict import main as predict_main

    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        (src / f"im{i}.png").write_bytes(encode_png(rng.integers(0, 255, (40, 56, 3), np.uint8)))
    out = io.StringIO()
    with redirect_stdout(out):
        summary = predict_main(["--demo", "--device", "cpu", "--mesh", "--input", str(src),
                                "--output", str(tmp_path / "out")])
    assert "[predict] mesh over 1 devices" in out.getvalue()
    assert summary["images"] == 2
    assert len(os.listdir(tmp_path / "out")) == 4
