"""The port's batch-predict CLI (image_segmentation_tpu_torch/predict.py):
the cases of tests/test_predict.py on the port (files → masks on disk,
ground-truth scoring with the original-resolution protocol, point
prompts), then `predict_paths` against the JAX package's on the same
weights: the same masks on disk and the same metrics."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from image_segmentation_tpu import predict as jax_predict
from image_segmentation_tpu.models import UNet as JaxUNet
from image_segmentation_tpu.serve.engine import InferenceEngine as JaxEngine
from image_segmentation_tpu_torch.models.convert import from_jax_variables
from image_segmentation_tpu_torch.models.unet import UNet
from image_segmentation_tpu_torch.predict import (
    list_inputs,
    load_image,
    load_label,
    main,
    predict_paths,
)
from image_segmentation_tpu_torch.serve.engine import InferenceEngine

torch.set_num_threads(1)


def _jax_tiny_unet():
    """JAX's tiny UNet of tests/test_predict.py, with its statistics moved
    off init (a zero mean stays zero, so the ReLUs keep firing)."""
    model = JaxUNet(num_classes=4, base=4)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)
    rng = np.random.default_rng(0)
    v = {"params": jax.tree_util.tree_map(
             lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
             v["params"]),
         "batch_stats": jax.tree_util.tree_map(
             lambda a: (np.asarray(a) * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
             v["batch_stats"])}
    return model, v


@pytest.fixture(scope="module")
def tiny_engine():
    _, v = _jax_tiny_unet()
    model = UNet(base=4)
    model.load_state_dict(from_jax_variables(v), strict=True)
    eng = InferenceEngine("cpu")
    eng.register("unet", model.to(memory_format=torch.channels_last), 32)
    return eng


def _write_images(d, n=3, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        h, w = int(rng.integers(20, 60)), int(rng.integers(20, 60))
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(d, f"img{i}.png"))
    return [os.path.join(d, f"img{i}.png") for i in range(n)]


def _write_labels(d, image_paths, seed=1):
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for p in image_paths:
        with Image.open(p) as im:
            w, h = im.size
        lab = rng.integers(0, 3, (h, w)).astype(np.uint8)
        lab[0, :] = 255  # boundary sentinel → 3 at load
        stem = os.path.splitext(os.path.basename(p))[0]
        Image.fromarray(lab, mode="L").save(os.path.join(d, f"{stem}.png"))


class _Fn(nn.Module):
    """A segmentation 'model' computing scores with a fixed function."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class _PromptFn(nn.Module):
    """A prompt 'model' for the composed registration: no clip branch to
    speak of, the head a fixed function of (image, heatmap)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def clip(self, x):
        return x.new_zeros(x.shape[:3] + (4,))

    def head(self, x, heatmap, logits):
        return self.fn(x, heatmap)


def _prompt_engine(name, fn):
    eng = InferenceEngine("cpu", fast_transfer=False)
    eng.register_prompt_composed(name, _PromptFn(fn), 32)
    return eng


def test_list_inputs_dir_sorted_and_single_file(tmp_path):
    paths = _write_images(str(tmp_path / "imgs"))
    assert list_inputs(str(tmp_path / "imgs")) == sorted(paths)
    assert list_inputs(paths[0]) == [paths[0]]
    (tmp_path / "imgs" / "notes.txt").write_text("skip me")
    assert list_inputs(str(tmp_path / "imgs")) == sorted(paths)


def test_list_inputs_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        list_inputs(str(tmp_path / "nope"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        list_inputs(str(tmp_path / "empty"))


def test_load_image_channels_and_range(tmp_path):
    from PIL import Image

    rgba = np.random.default_rng(0).integers(0, 255, (12, 9, 4), dtype=np.uint8)
    p = str(tmp_path / "a.png")
    Image.fromarray(rgba, mode="RGBA").save(p)
    img = load_image(p)
    assert img.shape == (12, 9, 3) and img.dtype == np.float32
    assert 0.0 <= img.min() and img.max() <= 1.0
    np.testing.assert_array_equal(img, jax_predict.load_image(p))


@pytest.mark.parametrize("prompt_space", [False, True])
def test_load_label_remaps_as_jax(tmp_path, prompt_space):
    from PIL import Image

    lab = np.zeros((6, 5), np.uint8)
    lab[0] = 255
    lab[1] = 2
    lab[2] = 1
    p = str(tmp_path / "l.png")
    Image.fromarray(lab, mode="L").save(p)
    out = load_label(p, prompt_space=prompt_space)
    assert out.shape == (6, 5) and out.dtype == np.int32
    want = {False: {0, 1, 2, 3}, True: {1, 2, 3}}[prompt_space]
    assert set(np.unique(out)) == want
    np.testing.assert_array_equal(out, jax_predict.load_label(p, prompt_space=prompt_space))


def test_writes_masks_at_original_sizes(tiny_engine, tmp_path):
    from PIL import Image

    paths = _write_images(str(tmp_path / "imgs"))
    out = str(tmp_path / "out")
    summary = predict_paths(tiny_engine, "unet", paths, output_dir=out, verbose=False)
    assert summary["images"] == len(paths)
    assert summary["class_names"] == ["background", "cat", "dog", "boundary"]
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        with Image.open(p) as im:
            size = im.size
        with Image.open(os.path.join(out, f"{stem}_mask.png")) as m:
            assert m.size == size and m.mode == "L"
            ids = np.asarray(m)
        assert ids.dtype == np.uint8 and ids.max() < 4
        with Image.open(os.path.join(out, f"{stem}_color.png")) as c:
            assert c.size == size and c.mode == "RGB"


def test_scoring_against_labels(tiny_engine, tmp_path):
    paths = _write_images(str(tmp_path / "imgs"))
    labels = str(tmp_path / "labels")
    _write_labels(labels, paths)
    summary = predict_paths(tiny_engine, "unet", paths, labels_dir=labels, verbose=False)
    assert summary["scored"] == len(paths)
    for k in ("mean_dice", "mean_iou", "mean_acc"):
        assert 0.0 <= summary[k] <= 1.0
    assert len(summary["per_class_iou"]) == 4


def test_scoring_skips_missing_labels(tiny_engine, tmp_path):
    paths = _write_images(str(tmp_path / "imgs"), n=2)
    labels = str(tmp_path / "labels")
    _write_labels(labels, paths[:1])
    assert predict_paths(tiny_engine, "unet", paths, labels_dir=labels,
                         verbose=False)["scored"] == 1


def test_perfect_prediction_scores_one(tmp_path):
    """A model whose argmax equals the labels scores Dice/IoU = 1."""
    from PIL import Image

    eng = InferenceEngine("cpu", fast_transfer=False)
    eng.register("echo", _Fn(lambda x: F.one_hot(
        torch.clamp((x[..., 0] * 4).long(), 0, 3), 4).float()), 32)
    img = np.zeros((32, 32, 3), np.uint8)
    img[:16] = 40  # class 0
    img[16:] = 150  # class 2
    p = str(tmp_path / "x.png")
    Image.fromarray(img).save(p)
    lab = np.zeros((32, 32), np.uint8)
    lab[16:] = 2
    labels = str(tmp_path / "labels")
    os.makedirs(labels)
    Image.fromarray(lab, mode="L").save(os.path.join(labels, "x.png"))
    summary = predict_paths(eng, "echo", [p], labels_dir=labels, verbose=False)
    assert summary["mean_dice"] == 1.0 and summary["mean_iou"] == 1.0


def test_label_shape_mismatch_raises(tiny_engine, tmp_path):
    from PIL import Image

    paths = _write_images(str(tmp_path / "imgs"), n=1)
    with Image.open(paths[0]) as im:
        w, h = im.size
    labels = str(tmp_path / "labels")
    os.makedirs(labels)
    # transposed: the same pixel count, the wrong shape
    Image.fromarray(np.zeros((w, h), np.uint8), mode="L").save(os.path.join(labels, "img0.png"))
    with pytest.raises(ValueError, match="shape"):
        predict_paths(tiny_engine, "unet", paths, labels_dir=labels, verbose=False)


def test_label_out_of_range_raises(tiny_engine, tmp_path):
    from PIL import Image

    paths = _write_images(str(tmp_path / "imgs"), n=1)
    with Image.open(paths[0]) as im:
        w, h = im.size
    labels = str(tmp_path / "labels")
    os.makedirs(labels)
    Image.fromarray(np.full((h, w), 7, np.uint8), mode="L").save(
        os.path.join(labels, "img0.png"))
    with pytest.raises(ValueError, match="outside"):
        predict_paths(tiny_engine, "unet", paths, labels_dir=labels, verbose=False)


def test_absent_class_iou_is_json_null(tiny_engine, tmp_path):
    from PIL import Image

    paths = _write_images(str(tmp_path / "imgs"), n=1)
    with Image.open(paths[0]) as im:
        w, h = im.size
    labels = str(tmp_path / "labels")
    os.makedirs(labels)
    Image.fromarray(np.zeros((h, w), np.uint8), mode="L").save(os.path.join(labels, "img0.png"))
    summary = predict_paths(tiny_engine, "unet", paths, labels_dir=labels, verbose=False)
    json.loads(json.dumps(summary, allow_nan=False))  # must not raise


def test_prompt_model_requires_point(tmp_path):
    eng = _prompt_engine("p", lambda x, hm: x.new_zeros(x.shape[:3] + (4,)))
    paths = _write_images(str(tmp_path / "imgs"), n=1)
    with pytest.raises(SystemExit, match="point"):
        predict_paths(eng, "p", paths, verbose=False)


def test_prompt_scoring_uses_prompt_label_space(tmp_path):
    """Labels on disk are in the segmentation space; scoring a prompt model
    remaps them to the prompt space, so a perfect prompt-space prediction
    scores 1."""
    from PIL import Image

    eng = _prompt_engine("oracle", lambda x, hm: F.one_hot(
        torch.where(x[..., 0] > 0.5, 3, 1), 4).float())
    img = np.zeros((32, 32, 3), np.uint8)
    img[16:] = 200  # bright → dog
    p = str(tmp_path / "x.png")
    Image.fromarray(img).save(p)
    lab = np.zeros((32, 32), np.uint8)
    lab[16:] = 2
    lab[0, :] = 255  # boundary → prompt background (1)
    labels = str(tmp_path / "labels")
    os.makedirs(labels)
    Image.fromarray(lab, mode="L").save(os.path.join(labels, "x.png"))
    summary = predict_paths(eng, "oracle", [p], labels_dir=labels, point=(16, 16),
                            ignore_index=None, verbose=False)
    assert summary["mean_dice"] == 1.0 and summary["mean_iou"] == 1.0


def test_prompt_model_gets_point_mask(tmp_path):
    """--point: the rendered heatmap reaches the model."""
    from PIL import Image

    eng = _prompt_engine("probe", lambda x, hm: F.one_hot(
        (hm[..., 0] > 0.5).long(), 4).float())
    p = str(tmp_path / "x.png")
    Image.fromarray(np.full((64, 64, 3), 128, np.uint8)).save(p)
    out = str(tmp_path / "out")
    summary = predict_paths(eng, "probe", [p], output_dir=out, point=(32, 32), verbose=False)
    assert summary["images"] == 1
    with Image.open(os.path.join(out, "x_mask.png")) as m:
        mask = np.asarray(m)
    assert mask[32, 32] == 1 and mask[0, 0] == 0


def test_predict_paths_matches_jax(tiny_engine, tmp_path):
    """The same tiny UNet's weights through JAX's predict_paths and the
    port's: the same mask and colour files and the same summary, but for
    the timings. Both engines move scores in bf16, so a pixel whose top
    two scores lie within a bf16 step could flip (tests/test_torch_serve.py
    allows those); these seeded images have none, so every pixel and
    every metric must agree."""
    from PIL import Image

    model, v = _jax_tiny_unet()
    j_eng = JaxEngine()
    j_eng.register("unet", model, v, target_size=32)
    paths = _write_images(str(tmp_path / "imgs"), n=4, seed=3)
    labels = str(tmp_path / "labels")
    _write_labels(labels, paths, seed=4)
    j_out, p_out = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_predict.predict_paths(j_eng, "unet", paths, output_dir=j_out, labels_dir=labels,
                                     verbose=False)
    got = predict_paths(tiny_engine, "unet", paths, output_dir=p_out, labels_dir=labels,
                        verbose=False)
    timing = ("images_per_sec", "first_image_s")
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k not in timing} == {
        k: v for k, v in want.items() if k not in timing}
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        for kind in ("mask", "color"):
            with Image.open(os.path.join(j_out, f"{stem}_{kind}.png")) as a, \
                    Image.open(os.path.join(p_out, f"{stem}_{kind}.png")) as b:
                assert a.mode == b.mode
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_demo_cli_end_to_end(tmp_path, capsys):
    """The CLI over the demo registry on the CPU: masks and a summary, the
    summary as the last line printed."""
    paths = _write_images(str(tmp_path / "imgs"), n=2)
    labels = str(tmp_path / "labels")
    _write_labels(labels, paths)
    out = str(tmp_path / "out")
    summary = main(["--demo", "--device", "cpu", "--input", str(tmp_path / "imgs"),
                    "--output", out, "--labels", labels, "--model", "unet"])
    assert summary["images"] == 2 and summary["scored"] == 2
    assert os.path.isfile(os.path.join(out, "img0_mask.png"))
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["model"] == "unet"


def test_cli_without_a_card_exits(tmp_path, monkeypatch):
    """--device defaults to cuda; without a card the CLI exits non-zero and
    says how to choose the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["--demo", "--input", str(tmp_path), "--output", str(tmp_path / "o")])
