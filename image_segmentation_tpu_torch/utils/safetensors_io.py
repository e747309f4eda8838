"""A safetensors reader and writer in the standard library and numpy.

The port's own copy of image_segmentation_tpu/utils/safetensors_io.py
(:39-114), so the CLIP weight converter reads an HF checkpoint
(`model.safetensors` of openai/clip-vit-base-patch16) on a host that has
neither torch's safetensors support nor the `safetensors` package. The
format:

    [8 bytes, little-endian uint64: N]
    [N bytes: JSON header {name: {dtype, shape, data_offsets}, ...}]
    [raw little-endian tensor data, offsets relative to byte 8 + N]

bfloat16 has no numpy dtype; it is widened to float32 by shifting the
stored uint16 into the high half of a uint32, which is exact: bf16 is
float32's top 16 bits.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

# safetensors dtype tag → numpy dtype of the raw read
_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    "BF16": np.uint16,  # read raw, then widened to float32
}


def _bf16_to_f32(raw_u16: np.ndarray) -> np.ndarray:
    """Exact widening: bf16 is the top 16 bits of an IEEE float32."""
    return (raw_u16.astype(np.uint32) << 16).view(np.float32)


def read_safetensors(path: str, prefix: Optional[str] = None) -> Dict[str, np.ndarray]:
    """{name: array} of a .safetensors file. `prefix` (e.g. 'vision_model.')
    keeps only the tensors whose names start with it; bf16 tensors come
    back widened to float32."""
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len).decode("utf-8"))
        header.pop("__metadata__", None)
        data_start = 8 + header_len
        out = {}
        for name in sorted(header):
            if prefix is not None and not name.startswith(prefix):
                continue
            info = header[name]
            tag = info["dtype"]
            if tag not in _DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {tag!r} "
                                 f"(supported: {sorted(_DTYPES)})")
            lo, hi = info["data_offsets"]
            shape = tuple(info["shape"])
            f.seek(data_start + lo)
            arr = np.frombuffer(f.read(hi - lo), dtype=_DTYPES[tag])
            if tag == "BF16":
                arr = _bf16_to_f32(arr)
            expected = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if arr.size != expected:
                raise ValueError(f"{path}: tensor {name!r} has {arr.size} elements, "
                                 f"header shape {shape} implies {expected}")
            out[name] = arr.reshape(shape)
    return out


def write_safetensors(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write {name: array} as a .safetensors file (no bf16: nothing here
    writes it)."""
    tag_of = {np.dtype(v): k for k, v in _DTYPES.items() if k != "BF16"}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        # not ascontiguousarray, which makes a 0-d array (1,); tobytes()
        # writes C order whatever the layout
        arr = np.asarray(tensors[name])
        tag = tag_of.get(arr.dtype)
        if tag is None:
            raise ValueError(f"unsupported write dtype {arr.dtype}")
        blob = arr.tobytes()
        header[name] = {"dtype": tag, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    hjson = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        for blob in blobs:
            f.write(blob)
