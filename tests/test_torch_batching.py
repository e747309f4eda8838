"""The port's BatchingEngine (serve/batching.py) on the CPU: the tests of
tests/test_serve.py:328-460 for the port, the prompt family through
batching, a failing forward or fetch submission that fails only its own
batch, a threaded stress run over all four families, and the port's
batched masks against the JAX BatchingEngine's with the same weights.

Batched masks are held to the direct ones (and to the JAX package's)
except at near-ties: a top-two gap below 1e-4 in the reference's
restored float32 scores, since a batch may sum in another order."""
import contextlib
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.models import UNet as JaxUNet
from image_segmentation_tpu.ops import geometry as JG
from image_segmentation_tpu.serve import engine as jax_engine
from image_segmentation_tpu.serve.batching import BatchingEngine as JaxBatchingEngine
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.ops import geometry as PG
from image_segmentation_tpu_torch.serve import app
from image_segmentation_tpu_torch.serve.batching import BatchingEngine
from image_segmentation_tpu_torch.serve.engine import InferenceEngine, stage_request
from image_segmentation_tpu_torch.serve.render import render_bbox, render_points

torch.set_num_threads(1)

NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def engine():
    """The four demo families, float32 transfer."""
    eng = InferenceEngine(device="cpu", fast_transfer=False)
    app.register_families(eng, app.demo_model_specs("cpu"))
    return eng


def _imgs(n, seed=0, hw=(40, 50)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (hw[0] + i, hw[1] + i, 3)).astype(np.float32) for i in range(n)]


def _near_ties(eng, img, name, prompt_mask=None):
    """Pixels where the direct path's restored scores are within NEAR_TIE
    of a tie between the top two classes."""
    entry = eng.models[name]
    inputs, meta = stage_request(img, entry, prompt_mask, eng.fast_transfer)
    scores = eng.forward(name, *(a[None] for a in inputs))[0]
    top = np.sort(PG.invert_resize_padding_np(scores, meta), axis=-1)
    return top[..., -1] - top[..., -2] < NEAR_TIE


def _assert_matches_direct(eng, got, img, name, prompt_mask=None):
    want = eng.segment(img, name, prompt_mask)["mask"]
    assert got.shape == want.shape == img.shape[:2]
    assert not np.any((got != want) & ~_near_ties(eng, img, name, prompt_mask))


def _run_threads(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


@contextlib.contextmanager
def _batch_sizes(entries):
    """Record the batch size of every dispatch of `entries` meanwhile."""
    sizes, originals = [], [(e, e.dispatch) for e in entries]
    for e, dispatch in originals:
        def counted(*inputs, dispatch=dispatch):
            sizes.append(inputs[0].shape[0])
            return dispatch(*inputs)
        e.dispatch = counted
    try:
        yield sizes
    finally:
        for e, dispatch in originals:
            e.dispatch = dispatch


def test_concurrent_results_match_direct(engine):
    be = BatchingEngine(engine, max_batch=4, max_wait_ms=20)
    try:
        imgs = _imgs(6)
        got = [None] * len(imgs)

        def run(i):
            got[i] = be.segment(imgs[i], "unet")["mask"]

        _run_threads(run, len(imgs))
        for i, img in enumerate(imgs):
            _assert_matches_direct(engine, got[i], img, "unet")
    finally:
        be.close()


def test_single_request_works(engine):
    be = BatchingEngine(engine, max_batch=8)
    try:
        img = _imgs(1, seed=1, hw=(30, 40))[0]
        out = be.segment(img, "clip")
        assert out["mask"].shape == (30, 40)
        _assert_matches_direct(engine, out["mask"], img, "clip")
    finally:
        be.close()


def test_segment_after_close_raises_and_close_is_idempotent(engine):
    be = BatchingEngine(engine, max_batch=4)
    be.close()
    with pytest.raises(RuntimeError, match="closed"):
        be.segment(np.zeros((16, 16, 3), np.float32), "unet")
    be.close()
    assert not be._worker.is_alive()


def test_two_models_both_served(engine):
    """Round-robin: concurrent requests to two models all complete."""
    be = BatchingEngine(engine, max_batch=2, max_wait_ms=2)
    try:
        imgs = [np.random.default_rng(2).uniform(0, 1, (24, 24, 3)).astype(np.float32)
                for _ in range(4)]
        results = {}

        def run(k):
            i, name = k // 2, ("unet", "clip")[k % 2]
            results[(i, name)] = be.segment(imgs[i], name, timeout=180)["mask"]

        _run_threads(run, 8)
        assert len(results) == 8 and all(m.shape == (24, 24) for m in results.values())
    finally:
        be.close()


def test_unknown_model_raises(engine):
    be = BatchingEngine(engine)
    try:
        with pytest.raises(KeyError):
            be.segment(np.zeros((8, 8, 3), np.float32), "nope")
    finally:
        be.close()


def test_prompt_family_through_batching(engine):
    """Concurrent clicks and boxes on the composed prompt family come back
    as the direct path gives them."""
    be = BatchingEngine(engine, max_batch=4, max_wait_ms=20)
    try:
        img = _imgs(1, seed=3, hw=(48, 64))[0]
        hw = img.shape[:2]
        prompts = [render_points([{"x": 8 * i, "y": 20}], hw) for i in range(4)]
        prompts += [render_bbox({"x": 4 * i, "y": 5, "width": 30, "height": 20}, hw)
                    for i in range(2)]
        got = [None] * len(prompts)

        def run(i):
            got[i] = be.segment(img, "prompt_model", prompts[i])
        _run_threads(run, len(prompts))
        for out, pm in zip(got, prompts):
            assert out["class_names"] == ["deactivated", "background", "cat", "dog"]
            _assert_matches_direct(engine, out["mask"], img, "prompt_model", pm)
    finally:
        be.close()


class _Flaky(torch.nn.Module):
    """Raises on an all-white batch, else returns zero logits."""

    def forward(self, x):
        if bool((x > 0.99).all()):
            raise RuntimeError("boom")
        return torch.zeros(x.shape[:3] + (4,))


def test_a_failing_forward_fails_only_its_batch():
    eng = InferenceEngine(device="cpu")
    eng.register("flaky", _Flaky(), 16)
    be = BatchingEngine(eng, max_batch=4, max_inflight=1)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            be.segment(np.ones((16, 16, 3), np.float32), "flaky", timeout=30)
        out = be.segment(np.zeros((16, 16, 3), np.float32), "flaky", timeout=30)
        assert out["mask"].shape == (16, 16) and not out["mask"].any()
    finally:
        be.close()


def test_a_failed_fetch_submit_releases_its_slot():
    """The fetch pool's submit sits inside the try (unlike
    image_segmentation_tpu/serve/batching.py:164): a submit that raises
    fails its batch and gives back its max_inflight slot, so with one slot
    the next request is still served."""
    eng = InferenceEngine(device="cpu")
    eng.register("zeros", _Flaky(), 16)
    be = BatchingEngine(eng, max_batch=4, max_inflight=1)
    submit, calls = be._fetch_pool.submit, []

    def failing_once(*args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("fetch pool refused the batch")
        return submit(*args)

    be._fetch_pool.submit = failing_once
    try:
        with pytest.raises(RuntimeError, match="refused"):
            be.segment(np.zeros((16, 16, 3), np.float32), "zeros", timeout=30)
        assert be.segment(np.zeros((8, 8, 3), np.float32), "zeros",
                          timeout=30)["mask"].shape == (8, 8)
        assert len(calls) == 2
    finally:
        be.close()


def test_warmup_runs_every_bucket_of_every_model(engine):
    be = BatchingEngine(engine, max_batch=6)
    try:
        with _batch_sizes(engine.models.values()) as sizes:
            be.warmup()
    finally:
        be.close()
    assert sizes == [1, 2, 4, 6] * 4


def test_stress_four_families_many_threads(engine):
    """24 client threads (more than the cores) with a short switch
    interval send 48 requests over the four families; every mask matches
    the direct path, and every dispatched prompt batch did exactly one
    cache lookup."""
    be = BatchingEngine(engine, max_batch=8, max_wait_ms=3)
    names = engine.available()
    imgs = _imgs(48, seed=4, hw=(30, 36))
    cache = engine.models["prompt_model"].score_cache
    lookups0 = cache.hits + cache.misses
    got = {}

    def run(t):
        for i in range(t, len(imgs), 24):
            name, img = names[i % 4], imgs[i]
            pm = (render_bbox({"x": 5, "y": 5, "width": 20, "height": 15}, img.shape[:2])
                  if name == "prompt_model" else None)
            got[i] = (name, img, pm, be.segment(img, name, pm, timeout=180)["mask"])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _batch_sizes([engine.models["prompt_model"]]) as prompt_batches:
            _run_threads(run, 24)
    finally:
        sys.setswitchinterval(interval)
        be.close()
    assert len(got) == 48 and sum(prompt_batches) >= 12
    assert cache.hits + cache.misses - lookups0 == len(prompt_batches)
    for name, img, pm, mask in got.values():
        _assert_matches_direct(engine, mask, img, name, pm)


def test_batched_masks_match_the_jax_batching_engine():
    """The JAX BatchingEngine and the port's, each over a UNet(base=8) with
    the same weights, serve the same concurrent requests alike."""
    model = JaxUNet(num_classes=4, base=8)
    v = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 64, 64, 3))))
    j_eng = jax_engine.InferenceEngine(fast_transfer=False)
    j_eng.register("unet", model, v, 64)
    port = UNet(base=8)
    port.load_state_dict(from_jax_variables(v), strict=True)
    p_eng = InferenceEngine(device="cpu", fast_transfer=False)
    p_eng.register("unet", port.to(memory_format=torch.channels_last).eval(), 64)
    imgs = _imgs(4, seed=5)
    out = {}
    for key, be in (("jax", JaxBatchingEngine(j_eng, max_batch=4, max_wait_ms=20)),
                    ("port", BatchingEngine(p_eng, max_batch=4, max_wait_ms=20))):
        try:
            def run(i, be=be, key=key):
                out[(key, i)] = be.segment(imgs[i], "unet", timeout=180)["mask"]
            _run_threads(run, len(imgs))
        finally:
            be.close()
    for i, img in enumerate(imgs):
        entry = j_eng.models["unet"]
        inputs, meta = jax_engine.stage_request(img, entry, None, False)
        scores = np.asarray(entry.forward(*[a[None] for a in inputs]), np.float32)[0]
        top = np.sort(JG.invert_resize_padding_np(scores, meta), axis=-1)
        near_tie = top[..., -1] - top[..., -2] < NEAR_TIE
        assert not np.any((out[("port", i)] != out[("jax", i)]) & ~near_tie)
