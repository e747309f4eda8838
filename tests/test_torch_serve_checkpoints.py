"""The port's checkpoint registry (`--models-dir`), its frontend and its
`main`, held against the JAX package's: JAX's
`build_engine_from_checkpoints` over Orbax `MO_` directories and the
port's over the same weights (converted by models/convert.py) serve the
same masks and scores for every family, at narrowed widths (both
registries' full-width specs narrowed the same way: JAX's model classes
through `functools.partial`, the port's through the keyword arguments
its registry's `build_model` gets)."""
import ast
import dataclasses
import functools
import inspect
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_segmentation_tpu.models as jax_models
import image_segmentation_tpu.models.clip_unet as jax_clip_unet
import image_segmentation_tpu.models.prompt as jax_prompt
from image_segmentation_tpu.ops import geometry as JG
from image_segmentation_tpu.serve import app as jax_app
from image_segmentation_tpu.serve import engine as jax_engine
from image_segmentation_tpu.train import checkpoint as jax_ckpt
from image_segmentation_tpu.models.clip_vit import ClipViTConfig as JaxViTConfig
from image_segmentation_tpu_torch import config as C
from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.serve import app
from image_segmentation_tpu_torch.serve import engine as port_engine
from image_segmentation_tpu_torch.train import checkpoint as port_ckpt

torch.set_num_threads(1)

VIT = dict(image_size=224, patch_size=16, hidden_size=64, num_layers=4, num_heads=4,
           mlp_dim=128)
CLIP_KW = dict(skip_indices=(1, 2, 3, 4), decoder_channels=(64, 32, 16, 8, 8))
BASE = 8
# JAX's model constructors at the narrowed widths, as load_family_models calls them
JAX_NARROW = {
    "UNet": functools.partial(jax_models.UNet, base=BASE),
    "SegmentationAutoencoder": functools.partial(jax_models.SegmentationAutoencoder, base=BASE),
    "ClipUNet": functools.partial(jax_clip_unet.ClipUNet, vit=JaxViTConfig(**VIT), **CLIP_KW),
    "PromptModel": functools.partial(jax_prompt.PromptModel, vit=JaxViTConfig(**VIT),
                                     unet_base=BASE, **CLIP_KW),
}
# the port's model keyword arguments at the same widths, by config.model
PORT_OVERRIDES = {
    "unet": dict(base=BASE),
    "autoencoder": dict(base=BASE),
    "clipunet": dict(vit=ClipViTConfig(**VIT), **CLIP_KW),
    "clipunet_noskips": dict(vit=ClipViTConfig(**VIT),
                             decoder_channels=CLIP_KW["decoder_channels"]),
    "prompt": dict(vit=ClipViTConfig(**VIT), unet_base=BASE, **CLIP_KW),
}


def narrow_port(monkeypatch, overrides):
    """The port's checkpoint registry builds each config's model with
    `overrides[config.model]`; the demo registry's own arguments win."""
    build = app.build_model
    monkeypatch.setattr(app, "build_model", lambda cfg, device, gen, **kw: build(
        cfg, device, gen, **{**overrides.get(cfg.model, {}), **kw}))
# MO_ directory written for each family
MO_DIRS = {"unet": "MO_unet_noaug", "autoencoder": "MO_autoencoder", "clip": "MO_clipunet",
           "prompt_model": "MO_prompt"}
FAMILIES = ["autoencoder", "clip", "prompt_model", "unet"]


@pytest.fixture
def narrow(monkeypatch):
    """Both registries at the narrowed widths, JAX's target sizes kept."""
    monkeypatch.setattr(jax_models, "UNet", JAX_NARROW["UNet"])
    monkeypatch.setattr(jax_models, "SegmentationAutoencoder",
                        JAX_NARROW["SegmentationAutoencoder"])
    monkeypatch.setattr(jax_clip_unet, "ClipUNet", JAX_NARROW["ClipUNet"])
    monkeypatch.setattr(jax_prompt, "PromptModel", JAX_NARROW["PromptModel"])
    narrow_port(monkeypatch, PORT_OVERRIDES)


def _perturbed(variables, seed):
    """Init variables moved off init: params + 0.05 N(0, 1), BN statistics
    + U(0, 0.5), so a registry serving init statistics would show."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)
    return {"params": jax.tree_util.tree_map(
                lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32), v["params"]),
            "batch_stats": jax.tree_util.tree_map(
                lambda a: (a + rng.uniform(0.0, 0.5, a.shape)).astype(np.float32),
                v["batch_stats"])}


def _jax_variables(name, seed):
    model = {"unet": JAX_NARROW["UNet"](num_classes=4),
             "autoencoder": JAX_NARROW["SegmentationAutoencoder"](num_classes=4),
             "clip": JAX_NARROW["ClipUNet"](num_classes=4),
             "prompt_model": JAX_NARROW["PromptModel"]()}[name]
    t = 256 if name in ("unet", "autoencoder") else 224
    sample = [jnp.zeros((1, t, t, 3))] + ([jnp.zeros((1, t, t, 1))]
                                          if name == "prompt_model" else [])
    return _perturbed(model.init(jax.random.PRNGKey(seed), *sample, train=False), seed)


def _write_mo(jax_dir, port_dir, mo, variables):
    jax_ckpt.save_params_only(os.path.join(jax_dir, mo), variables["params"],
                              variables["batch_stats"])
    port_ckpt.save_params_only(os.path.join(port_dir, mo), from_jax_variables(variables))


@pytest.fixture(scope="module")
def models_dirs(tmp_path_factory):
    """The four families' perturbed weights as JAX (Orbax) and port MO_
    directories."""
    jax_dir = str(tmp_path_factory.mktemp("jax_models"))
    port_dir = str(tmp_path_factory.mktemp("port_models"))
    for i, name in enumerate(FAMILIES):
        _write_mo(jax_dir, port_dir, MO_DIRS[name], _jax_variables(name, i))
    return jax_dir, port_dir


def _scores_and_gap(eng, name, img, pm, fetch):
    """Staged scores of one request and the restored top-two gap."""
    entry = eng.models[name]
    stage = jax_engine.stage_request if fetch is None else port_engine.stage_request
    inputs, meta = stage(img, entry, pm, True)
    batch = [x[None] for x in inputs]
    scores = (np.asarray(entry.forward(*batch), np.float32) if fetch is None
              else eng.forward(name, *batch))[0]
    restored = np.sort(JG.invert_resize_padding_np(scores, meta), axis=-1)
    return scores, restored[..., -1] - restored[..., -2]


def test_checkpoint_registry_matches_jax(narrow, models_dirs):
    """Every family, the same MO_ weights: scores within one bf16 step of
    the largest (both engines move scores as bf16; JAX's composed prompt
    path also softmaxes bf16-cast logits, engine.py:142), and masks equal
    except where JAX's restored top-two gap is under that step (the near
    ties of tests/test_torch_serve.py)."""
    jax_dir, port_dir = models_dirs
    j_eng = jax_app.build_engine_from_checkpoints(jax_dir)
    p_eng = app.build_engine_from_checkpoints(port_dir, "cpu")
    assert p_eng.available() == j_eng.available() == FAMILIES
    img = np.random.default_rng(7).uniform(0, 1, (50, 70, 3)).astype(np.float32)
    pm = np.zeros((50, 70), np.float32)
    pm[20:30, 30:40] = 1.0
    for name in FAMILIES:
        jp, pp = p_eng.models[name], j_eng.models[name]
        assert (jp.target_size, jp.needs_prompt, jp.class_names) == (
            pp.target_size, pp.needs_prompt, tuple(pp.class_names))
        prompt = pm if jp.needs_prompt else None
        want, gap = _scores_and_gap(j_eng, name, img, prompt, None)
        got, _ = _scores_and_gap(p_eng, name, img, prompt, p_eng.fetch)
        tol = 2.0**-7 * np.abs(want).max()
        err = float(np.abs(got - want).max())
        got_mask = p_eng.segment(img, name, prompt)["mask"]
        want_mask = j_eng.segment(img, name, prompt)["mask"]
        differ = got_mask != want_mask
        print(f"{name}: max |port - JAX| = {err:.3g} (tol {tol:.3g}); "
              f"{int(differ.sum())} differing pixels, {int((gap < tol).sum())} near-ties")
        assert err <= tol
        assert not np.any(differ & (gap >= tol))


def test_candidate_names_and_order_are_jax():
    """The MO_ names each family is served from, in JAX's order
    (app.py:197-204), read from JAX's source."""
    src = inspect.getsource(jax_app.load_family_models)
    node = next(n for n in ast.walk(ast.parse(src.lstrip()))
                if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "candidates")
    want = ast.literal_eval(node.value)
    got = {name: tuple(c for c, _ in spec.candidates) for name, spec in app.FAMILY_SPECS.items()}
    assert got == want
    assert {name: spec.target_size for name, spec in app.FAMILY_SPECS.items()} == {
        "unet": 256, "autoencoder": 256, "clip": 224, "prompt_model": 224}
    # MO_clipunet_noskips is served as the ClipUNetNoSkips it was trained as
    assert dict(app.FAMILY_SPECS["clip"].candidates)["MO_clipunet_noskips"] is C.CLIPUNET_NOSKIPS


def test_first_candidate_wins_as_in_jax(narrow, tmp_path):
    """MO_unet_aug and MO_unet_noaug both present: both registries serve
    MO_unet_aug (the earlier candidate), not the other weights."""
    jax_dir, port_dir = str(tmp_path / "j"), str(tmp_path / "p")
    aug, noaug = _jax_variables("unet", 10), _jax_variables("unet", 11)
    _write_mo(jax_dir, port_dir, "MO_unet_aug", aug)
    _write_mo(jax_dir, port_dir, "MO_unet_noaug", noaug)
    j_eng = jax_app.build_engine_from_checkpoints(jax_dir)
    p_eng = app.build_engine_from_checkpoints(port_dir, "cpu")
    img = np.random.default_rng(8).uniform(0, 1, (40, 40, 3)).astype(np.float32)
    want, _ = _scores_and_gap(j_eng, "unet", img, None, None)
    got, _ = _scores_and_gap(p_eng, "unet", img, None, p_eng.fetch)
    other = port_engine.InferenceEngine("cpu")
    other.register("unet", app.load_family_model(os.path.join(port_dir, "MO_unet_noaug"),
                                                 C.UNET_NOAUG, "cpu"), 256)
    not_this, _ = _scores_and_gap(other, "unet", img, None, other.fetch)
    tol = 2.0**-7 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol < np.abs(not_this - want).max()


def test_raises_when_nothing_is_found(tmp_path):
    (tmp_path / "MO_something_else").mkdir()
    with pytest.raises(RuntimeError, match="no model checkpoints"):
        jax_app.build_engine_from_checkpoints(str(tmp_path))
    with pytest.raises(RuntimeError, match="no model checkpoints"):
        app.build_engine_from_checkpoints(str(tmp_path), "cpu")


def test_trained_bn_statistics_are_served(narrow, tmp_path):
    """The registry serves the checkpoint's running statistics: the same
    parameters with other statistics give other scores, and a checkpoint
    without its statistics is refused rather than served with init ones."""
    v = _jax_variables("unet", 12)
    rng = np.random.default_rng(3)
    moved = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(
        lambda a: (a * rng.uniform(1.5, 2.5, a.shape)).astype(np.float32), v["batch_stats"])}
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    port_ckpt.save_params_only(os.path.join(a_dir, "MO_unet"), from_jax_variables(v))
    port_ckpt.save_params_only(os.path.join(b_dir, "MO_unet"), from_jax_variables(moved))
    img = np.random.default_rng(9).uniform(0, 1, (40, 40, 3)).astype(np.float32)
    sa = app.build_engine_from_checkpoints(a_dir, "cpu")
    sb = app.build_engine_from_checkpoints(b_dir, "cpu")
    got_a, _ = _scores_and_gap(sa, "unet", img, None, sa.fetch)
    got_b, _ = _scores_and_gap(sb, "unet", img, None, sb.fetch)
    assert np.abs(got_a - got_b).max() > 0.25 * np.abs(got_a).max()
    state = from_jax_variables(v)
    no_stats = {k: t for k, t in state.items() if not k.endswith("running_var")}
    port_ckpt.save_params_only(os.path.join(str(tmp_path / "c"), "MO_unet"), no_stats)
    with pytest.raises(RuntimeError, match="running_var"):
        app.build_engine_from_checkpoints(str(tmp_path / "c"), "cpu")


def test_clipunet_noskips_jax_raises_port_serves(narrow, tmp_path):
    """A models directory whose only CLIP artifact is MO_clipunet_noskips.
    JAX builds a ClipUNet for every clip candidate (app.py:187,203) and
    fails on the ClipUNetNoSkips variables (flax ScopeParamShapeError at
    dec_0's transpose conv); the port serves it as the ClipUNetNoSkips it
    was trained as, with JAX's ClipUNetNoSkips scores."""
    from flax.errors import ScopeParamShapeError

    noskips = jax_clip_unet.ClipUNetNoSkips(
        num_classes=4, vit=JaxViTConfig(**VIT), decoder_channels=CLIP_KW["decoder_channels"])
    v = _perturbed(noskips.init(jax.random.PRNGKey(4), jnp.zeros((1, 224, 224, 3)),
                                train=False), 4)
    jax_dir, port_dir = str(tmp_path / "j"), str(tmp_path / "p")
    _write_mo(jax_dir, port_dir, "MO_clipunet_noskips", v)
    img = np.random.default_rng(10).uniform(0, 1, (60, 45, 3)).astype(np.float32)
    with pytest.raises(ScopeParamShapeError, match="dec_0/UpConv_0/ConvTranspose_0"):
        jax_app.build_engine_from_checkpoints(jax_dir).segment(img, "clip")

    p_eng = app.build_engine_from_checkpoints(port_dir, "cpu")
    assert p_eng.available() == ["clip"]
    ref = jax_engine.InferenceEngine()
    ref.register("clip", noskips, v, 224)
    want, gap = _scores_and_gap(ref, "clip", img, None, None)
    got, _ = _scores_and_gap(p_eng, "clip", img, None, p_eng.fetch)
    assert np.abs(got - want).max() <= 2.0**-7 * np.abs(want).max()


def test_trained_run_serves_from_its_save_dir(tmp_path, monkeypatch):
    """`run.main --synthetic` on the CPU writes MO_unet_noaug and (with
    --cache-features, smoke ViT) MO_clipunet; the registry serves both from
    the save dir, each as its trained weights give."""
    from image_segmentation_tpu_torch import run

    save = str(tmp_path / "runs")
    run.main(["--config", "unet_noaug", "--synthetic", "8", "--epochs", "1",
              "--target-size", "32", "--device", "cpu", "--save-dir", save])
    run.main(["--config", "clipunet", "--smoke-vit", "--cache-features", "--synthetic", "8",
              "--epochs", "1", "--target-size", "64", "--device", "cpu", "--save-dir", save])
    monkeypatch.setitem(app.FAMILY_SPECS, "unet",
                        dataclasses.replace(app.FAMILY_SPECS["unet"], target_size=32))
    cfg64 = dataclasses.replace(C.CLIPUNET, target_size=64)
    monkeypatch.setitem(app.FAMILY_SPECS, "clip",
                        dataclasses.replace(app.FAMILY_SPECS["clip"], target_size=64))
    narrow_port(monkeypatch, {"clipunet": run._smoke_vit_overrides(cfg64)})
    eng = app.build_engine_from_checkpoints(save, "cpu")
    assert eng.available() == ["clip", "unet"]
    img = np.random.default_rng(11).uniform(0, 1, (37, 53, 3)).astype(np.float32)
    for name, cfg, mo, tsize, over in (
            ("unet", C.UNET_NOAUG, "MO_unet_noaug", 32, {}),
            ("clip", C.CLIPUNET, "MO_clipunet", 64, run._smoke_vit_overrides(cfg64))):
        model = C.build_model(cfg, "cpu", torch.Generator().manual_seed(5), **over)
        model.load_state_dict(torch.load(os.path.join(save, mo, port_ckpt.WEIGHTS_FILE)))
        ref = port_engine.InferenceEngine("cpu")
        ref.register(name, model, tsize)
        np.testing.assert_array_equal(eng.segment(img, name)["mask"],
                                      ref.segment(img, name)["mask"])


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_frontend_is_jax_frontend_and_guards_traversal():
    """The assets are JAX's byte for byte, served at / and /static/*; paths
    that leave static/ are 404 (JAX app.py:311-319)."""
    jax_serve = os.path.dirname(jax_app.__file__)
    for rel in ("templates/index.html", "static/script.js", "static/style.css"):
        with open(os.path.join(jax_serve, rel), "rb") as a, \
                open(os.path.join(os.path.dirname(app.__file__), rel), "rb") as b:
            assert a.read() == b.read(), rel
    eng = port_engine.InferenceEngine("cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), app.make_handler(eng))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with open(os.path.join(app.TEMPLATE_DIR, "index.html"), "rb") as f:
            page = f.read()
        assert _get(base + "/") == (200, "text/html", page)
        assert _get(base + "/index.html")[2] == page
        code, ctype, body = _get(base + "/static/script.js")
        with open(os.path.join(app.STATIC_DIR, "script.js"), "rb") as f:
            assert (code, ctype, body) == (200, "application/javascript", f.read())
        assert _get(base + "/static/style.css")[:2] == (200, "text/css")
        for bad in ("/static/../app.py", "/static/%2e%2e/app.py", "/static/../../README.md",
                    "/static/", "/static/nope.js"):
            code, _, body = _get(base + bad)
            assert code == 404 and json.loads(body) == {"error": "not found"}, bad
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


class _Server:
    def __init__(self, address, handler):
        self.address = address

    def serve_forever(self):
        pass


def test_main_flags(monkeypatch, models_dirs, narrow, tmp_path):
    """--device cuda (the default) without a card exits non-zero with the
    --models-dir and --exports-dir registries too; --models-dir builds the
    checkpoint registry; neither directory falls back to the demo one
    (JAX app.py:410); --exports-dir serves the programs in it beside
    --models-dir, and an empty one is refused."""
    from image_segmentation_tpu_torch.serve import export

    _, port_dir = models_dirs
    engines = []
    monkeypatch.setattr(app, "ThreadingHTTPServer", _Server)
    monkeypatch.setattr(app, "make_handler", lambda eng: engines.append(eng))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--models-dir", port_dir], ["--exports-dir", str(tmp_path)], []):
        with pytest.raises(SystemExit) as e:
            app.main(argv)
        assert "--device cpu" in str(e.value.code)
    app.main(["--models-dir", port_dir, "--device", "cpu"])
    assert engines[-1].available() == FAMILIES
    assert engines[-1].models["unet"].target_size == 256
    app.main(["--device", "cpu"])
    assert engines[-1].models["unet"].target_size == app.DEMO_TARGET
    with pytest.raises(SystemExit, match="no .istpt programs"):
        app.main(["--exports-dir", str(tmp_path), "--device", "cpu"])
    demo = app.build_demo_engine("cpu")
    export.save_exported(str(tmp_path / "unet_demo.istpt"),
                         next(m for n, m, *_ in app.demo_model_specs("cpu") if n == "unet"),
                         app.DEMO_TARGET, name="unet_demo",
                         class_names=demo.models["unet"].class_names)
    app.main(["--exports-dir", str(tmp_path), "--models-dir", port_dir, "--device", "cpu"])
    assert engines[-1].available() == FAMILIES + ["unet_demo"]
