"""The serving profiler's readings, on the CPU at the demo widths: each
function returns what it says for every family, a mixed load never sends
an image twice (the prompt family's score cache stays cold), and the
command refuses to run without a card."""
import numpy as np
import pytest
import torch

from image_segmentation_tpu_torch.serve import app, profiling
from image_segmentation_tpu_torch.serve.batching import BatchingEngine

torch.set_num_threads(1)

FAMILIES = ["autoencoder", "clip", "prompt_model", "unet"]


@pytest.fixture(scope="module")
def engine():
    return app.build_demo_engine("cpu")


def test_mixed_load_hands_out_each_request_once():
    load = profiling.MixedLoad(FAMILIES, 10)
    assert list(load.take(4)) == [0, 1, 2, 3] and list(load.take(6)) == list(range(4, 10))
    with pytest.raises(ValueError, match="holds 10 images"):
        load.take(1)
    image, name, prompt = load.request(6)
    assert name == "prompt_model" and prompt.shape == image.shape[:2] == profiling.IMAGE_HW
    assert load.request(7)[2] is None
    assert not np.array_equal(load.images[2], load.images[6])


def test_host_split_and_launches_cover_every_family(engine):
    load = profiling.MixedLoad(engine.available(), 4 * (3 + 1))
    split = profiling.host_split(engine, load, n=3, skip=1)
    launches = profiling.launches_per_request(engine, load, n=1)
    assert sorted(split) == sorted(launches) == FAMILIES
    for name in FAMILIES:
        assert len(split[name]) == 4 and all(np.isfinite(t) and t >= 0 for t in split[name])
        kernels, copies, device_ms = launches[name]
        assert (kernels, copies, device_ms) == (0, 0, 0)  # no CUDA device here
    assert engine.models["prompt_model"].score_cache.hits == 0


def test_requests_per_s_direct_and_batched(engine):
    load = profiling.MixedLoad(engine.available(), 16, seed=1)  # images the engine has not seen
    hits =engine.models["prompt_model"].score_cache.hits
    assert profiling.requests_per_s(engine.segment, load, 8, clients=1) > 0
    be = BatchingEngine(engine, max_batch=2, max_wait_ms=1)
    try:
        assert profiling.requests_per_s(be.segment, load, 8, clients=4) > 0
    finally:
        be.close()
    assert engine.models["prompt_model"].score_cache.hits == hits


def test_main_without_cuda_exits_non_zero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        profiling.main()
    assert "no CUDA device" in str(e.value.code)
