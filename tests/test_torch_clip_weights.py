"""The port's CLIP weight path: its safetensors reader and writer
(`utils/safetensors_io.py`), its converter (`python -m
image_segmentation_tpu_torch.utils.convert_clip_weights`) and its loader
(`models.clip_vit.load_pretrained_clip_state`), held against the JAX
package's. One converted `.npz` serves both packages: an HF-layout vision
state dict converted by the port is read by JAX's
`load_pretrained_clip_params` and by the port, into ViTs whose outputs
agree."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_segmentation_tpu.models.clip_vit import ClipViT as JaxClipViT
from image_segmentation_tpu.models.clip_vit import ClipViTConfig as JaxViTConfig
from image_segmentation_tpu.models.clip_vit import convert_hf_vision_state_dict
from image_segmentation_tpu.models.clip_vit import load_pretrained_clip_params
from image_segmentation_tpu.utils import safetensors_io as jax_st
from image_segmentation_tpu_torch.models.clip_vit import (
    ClipViT,
    ClipViTConfig,
    hf_vision_npz_arrays,
    load_pretrained_clip_state,
)
from image_segmentation_tpu_torch.utils import convert_clip_weights
from image_segmentation_tpu_torch.utils.safetensors_io import read_safetensors, write_safetensors

torch.set_num_threads(1)

VIT = dict(image_size=64, patch_size=16, hidden_size=32, num_layers=2, num_heads=2, mlp_dim=64)


def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    return {"vision_model.a": rng.normal(size=(3, 4)).astype(np.float32),
            "vision_model.b": np.arange(6, dtype=np.int64).reshape(2, 3),
            "text_model.c": rng.normal(size=(5,)).astype(np.float16),
            "scalar": np.array(2.5, np.float32)}  # 0-d


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_round_trip_and_prefix_filter(tmp_path, writer):
    """The port's reader reads back what either package's writer wrote:
    values, dtypes and shapes (a 0-d tensor too); `prefix` keeps only the
    names that start with it. JAX's reader reads the port's file the same."""
    tensors = _tensors()
    path = str(tmp_path / "x.safetensors")
    (write_safetensors if writer == "port" else jax_st.write_safetensors)(path, tensors)
    got = read_safetensors(path)
    other = jax_st.read_safetensors(path)
    assert set(got) == set(other) == set(tensors)
    for k, want in tensors.items():
        for g in (got[k], other[k]):
            np.testing.assert_array_equal(g, want)
            assert g.dtype == want.dtype and g.shape == want.shape
    assert set(read_safetensors(path, prefix="vision_model.")) == {"vision_model.a",
                                                                   "vision_model.b"}


def _raw_file(path, header, payload: bytes):
    hjson = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        f.write(payload)


def test_bf16_widens_exactly(tmp_path):
    """bf16 is float32's top 16 bits: the widened values are those bits
    shifted up, bit for bit, and within a bf16 step of the f32 source."""
    f32 = np.array([0.0, 1.0, -2.5, 3.14159, 1e30], np.float32)
    bits = (f32.view(np.uint32) >> 16).astype(np.uint16)
    path = str(tmp_path / "bf16.safetensors")
    _raw_file(path, {"w": {"dtype": "BF16", "shape": [5], "data_offsets": [0, 10]}},
              bits.tobytes())
    got = read_safetensors(path)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, (bits.astype(np.uint32) << 16).view(np.float32))
    np.testing.assert_array_equal(got, jax_st.read_safetensors(path)["w"])
    np.testing.assert_allclose(got, f32, rtol=2**-7)


def test_metadata_ignored_and_bad_shape_rejected(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    _raw_file(path, {"__metadata__": {"format": "pt"},
                     "w": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}},
              np.zeros(2, np.float32).tobytes())
    with pytest.raises(ValueError, match="header shape"):
        read_safetensors(path)


def test_unsupported_dtypes_rejected(tmp_path):
    path = str(tmp_path / "f8.safetensors")
    _raw_file(path, {"w": {"dtype": "F8_E4M3", "shape": [1], "data_offsets": [0, 1]}},
              b"\x00")
    with pytest.raises(ValueError, match="unsupported dtype"):
        read_safetensors(path)
    with pytest.raises(ValueError, match="unsupported write dtype"):
        write_safetensors(str(tmp_path / "c.safetensors"), {"z": np.zeros(2, np.complex64)})


def _hf_vision_state(seed=0):
    """An HF CLIPVisionModel-layout state dict of VIT's geometry, with the
    `vision_model.` prefix, the post-layernorm the converter drops, and a
    text-tower tensor the converter's prefix filter skips."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (0.2 * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    h, m, p = VIT["hidden_size"], VIT["mlp_dim"], VIT["patch_size"]
    n_pos = (VIT["image_size"] // p) ** 2 + 1
    t = {"embeddings.patch_embedding.weight": r(h, 3, p, p),
         "embeddings.class_embedding": r(h),
         "embeddings.position_embedding.weight": r(n_pos, h),
         "pre_layrnorm.weight": 1 + r(h), "pre_layrnorm.bias": r(h),
         "post_layernorm.weight": r(h), "post_layernorm.bias": r(h)}
    for i in range(VIT["num_layers"]):
        pre = f"encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            t[f"{pre}{ln}.weight"], t[f"{pre}{ln}.bias"] = 1 + r(h), r(h)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            t[f"{pre}self_attn.{proj}.weight"], t[f"{pre}self_attn.{proj}.bias"] = r(h, h), r(h)
        t[f"{pre}mlp.fc1.weight"], t[f"{pre}mlp.fc1.bias"] = r(m, h), r(m)
        t[f"{pre}mlp.fc2.weight"], t[f"{pre}mlp.fc2.bias"] = r(h, m), r(h)
    return {f"vision_model.{k}": v for k, v in t.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("source", ["safetensors", "torch-state-dict"])
def test_converted_npz_loads_into_both_packages(tmp_path, source):
    """HF layout → the port's converter → .npz. Its arrays are JAX's
    converter's (`convert_hf_vision_state_dict`), bit for bit; JAX's
    `load_pretrained_clip_params` and the port's loader read it into ViTs
    whose hidden states agree (f32, within 1e-5 of values up to ~10), and
    the port's ViT holds exactly the HF values."""
    hf = _hf_vision_state()
    if source == "safetensors":
        src = str(tmp_path / "model.safetensors")
        write_safetensors(src, {**hf, "text_model.x": np.ones(3, np.float32)})
    else:
        src = str(tmp_path / "vision.pt")
        torch.save({k: torch.from_numpy(v) for k, v in hf.items()}, src)
    out = str(tmp_path / "clip.npz")
    assert convert_clip_weights.main([f"--{source}", src, "--out", out]) == 0

    with np.load(out) as npz:
        got = {k: npz[k] for k in npz.files}
    want = _flat(convert_hf_vision_state_dict(hf))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    port = ClipViT(ClipViTConfig(**VIT))
    port.load_state_dict(load_pretrained_clip_state(out), strict=True)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), hf[f"vision_model.{k}"], err_msg=k)
    jparams = load_pretrained_clip_params(cache_path=out)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want_last, want_hidden = JaxClipViT(JaxViTConfig(**VIT)).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, jparams)}, jnp.asarray(x))
    with torch.no_grad():
        last, hidden = port(torch.from_numpy(x))
    for g, w in zip([last] + hidden, [want_last] + list(want_hidden)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_npz_round_trip_through_the_port(tmp_path):
    """The port's ClipViT state → `hf_vision_npz_arrays` → .npz →
    `load_pretrained_clip_state`: the same state dict, bit for bit."""
    vit = ClipViT(ClipViTConfig(**VIT))
    vit.init_weights(torch.Generator().manual_seed(0))
    path = str(tmp_path / "v.npz")
    np.savez(path, **hf_vision_npz_arrays(vit.state_dict()))
    back = load_pretrained_clip_state(path)
    assert back.keys() == vit.state_dict().keys()
    for k, v in vit.state_dict().items():
        assert torch.equal(back[k], v), k


def test_non_clip_safetensors_exits(tmp_path):
    src = str(tmp_path / "other.safetensors")
    write_safetensors(src, {"text_model.x": np.ones(2, np.float32)})
    with pytest.raises(SystemExit, match="no 'vision_model"):
        convert_clip_weights.main(["--safetensors", src, "--out", str(tmp_path / "o.npz")])
