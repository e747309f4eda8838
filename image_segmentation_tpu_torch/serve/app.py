"""HTTP serving app for the port (stdlib http.server).

Counterpart of image_segmentation_tpu/serve/app.py:
  GET  /models   — registry listing
  POST /segment  — JSON {image: b64, model: name, [prompt_type,
                   prompt_data], [label: b64]} →
                   {output_mask: b64 PNG, [output_label: b64 PNG], class_names}

Prompt models take `prompt_type` ("points" by default, "bbox",
"scribble", "text") and `prompt_data` (a list of {x, y}; {x, y, width,
height}; a base64 PNG of the strokes); malformed prompt data is the
client's error (400). Uploads decode and masks encode with PIL.

`--demo` serves the JAX package's four random-weight families at its
demo widths where the kernels allow (`demo_model_specs`): unet and
autoencoder at base 8; clip and prompt_model with a ViT of hidden 128,
MLP 256 and 2 heads (head dim 64, so on CUDA K3 and K4 run), the prompt
model's selection UNet at base 8; all at 64 px. The prompt family is
always composed (`InferenceEngine.register_prompt_composed`). On CUDA
the models compute in bfloat16 with the hand-written kernels, on the CPU
in float32 with their plain versions. `--device` is explicit: cuda by
default, and the server refuses to start when there is none. With
`--max-batch N` requests are micro-batched (`serve/batching.py`) after a
warm-up of every batch size. The interactive frontend, checkpoints
(`--models-dir`), AOT artifacts and `--mesh` come with later slices.

Run: python -m image_segmentation_tpu_torch.serve.app --demo
     [--device cpu] [--max-batch 4] [--port 8000]
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from image_segmentation_tpu_torch.config import (
    AUTOENCODER,
    CLIPUNET,
    PROMPT,
    UNET_NOAUG,
    build_model,
)
from image_segmentation_tpu_torch.data.dataset import normalize_image_channels
from image_segmentation_tpu_torch.data.labels import colorize_mask, target_remap
from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig
from image_segmentation_tpu_torch.serve.engine import InferenceEngine
from image_segmentation_tpu_torch.serve.render import create_prompt_mask

DEMO_VIT = ClipViTConfig(image_size=64, patch_size=16, hidden_size=128,
                         num_layers=3, num_heads=2, mlp_dim=256)
DEMO_TARGET = 64


def _strip_data_url(data: str) -> bytes:
    if "," in data[:64] and data.lstrip().startswith("data:"):
        data = data.split(",", 1)[1]
    return base64.b64decode(data)


def decode_base64_image(data: str) -> np.ndarray:
    """b64 (optionally a data URL) → (H, W, 3) float32 in [0, 1], alpha dropped."""
    from PIL import Image

    with Image.open(io.BytesIO(_strip_data_url(data))) as im:
        arr = np.asarray(im.convert("RGBA") if im.mode == "P" else im)
    return normalize_image_channels(arr).astype(np.float32) / 255.0


def decode_base64_gray(data: str) -> np.ndarray:
    from PIL import Image

    with Image.open(io.BytesIO(_strip_data_url(data))) as im:
        return np.asarray(im.convert("L"))


def encode_png_base64(arr: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def demo_model_specs(device, seed: int = 0):
    """(name, model, target_size, needs_prompt) for the random-weight,
    reduced-width families of the JAX demo registry (app.py:99-143), each
    seeded from `seed`, in eval mode on `device`."""
    clip_kw = dict(vit=DEMO_VIT, skip_indices=(0, 1, 2, 3), decoder_channels=(64, 32, 16, 8, 8))
    builders = {
        "unet": (UNET_NOAUG, dict(base=8), False),
        "autoencoder": (AUTOENCODER, dict(base=8), False),
        "clip": (CLIPUNET, clip_kw, False),
        "prompt_model": (PROMPT, dict(clip_kw, unet_base=8), True),
    }
    for name, (cfg, kw, needs_prompt) in builders.items():
        model = build_model(cfg, device, torch.Generator().manual_seed(seed), **kw)
        yield name, model, DEMO_TARGET, needs_prompt


def register_families(eng: InferenceEngine, families) -> None:
    """Register (name, model, target_size, needs_prompt) specs; prompt
    models always go through `register_prompt_composed`."""
    for name, model, tsize, needs_prompt in families:
        if needs_prompt:
            eng.register_prompt_composed(name, model, tsize)
        else:
            eng.register(name, model, tsize)


def build_demo_engine(device="cuda", seed: int = 0) -> InferenceEngine:
    """A registry of the four random-weight, reduced-width families, on the
    card unless `device` says otherwise."""
    eng = InferenceEngine(device=device)
    register_families(eng, demo_model_specs(device, seed))
    return eng


def handle_segment(engine, payload: dict) -> dict:
    """Core of POST /segment, for an InferenceEngine or a BatchingEngine."""
    model_name = payload.get("model")
    if not model_name:
        return {"error": "missing 'model'"}
    if model_name not in engine.models:
        return {"error": f"unknown model {model_name!r}",
                "available": engine.available()}
    if "image" not in payload:
        return {"error": "missing 'image'"}
    try:
        image = decode_base64_image(payload["image"])
    except Exception as e:  # any undecodable upload is the client's error
        return {"error": f"could not decode image: {e}"}

    prompt_mask = None
    if engine.models[model_name].needs_prompt:
        ptype = payload.get("prompt_type", "points")
        pdata = payload.get("prompt_data")
        if ptype == "scribble" and isinstance(pdata, str):
            try:
                pdata = decode_base64_gray(pdata)
            except Exception as e:  # an undecodable scribble is the client's error
                return {"error": f"could not decode scribble: {e}"}
        try:
            prompt_mask = create_prompt_mask(ptype, pdata, image.shape[:2])
        except (TypeError, KeyError, ValueError, IndexError) as e:
            return {"error": f"invalid prompt_data for {ptype!r}: {e}"}

    result = engine.segment(image, model_name, prompt_mask)
    out = {
        "output_mask": encode_png_base64(result["color_mask"]),
        "class_names": result["class_names"],
    }
    if payload.get("label"):
        try:
            lab = target_remap(decode_base64_gray(payload["label"]))
            out["output_label"] = encode_png_base64(colorize_mask(lab))
        except Exception as e:  # the label is optional; report, keep the mask
            out["label_error"] = str(e)
    return out


def make_handler(engine: InferenceEngine):
    class Handler(BaseHTTPRequestHandler):
        def _send_json(self, obj, code: int = 200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/models":
                self._send_json({"models": engine.available()})
            else:
                self._send_json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path != "/segment":
                self._send_json({"error": "not found"}, 404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._send_json({"error": f"bad request: {e}"}, 400)
                return
            try:
                out = handle_segment(engine, payload)
            except Exception as e:  # the server keeps serving; report the fault
                self._send_json({"error": f"internal error: {e}"}, 500)
                return
            self._send_json(out, 400 if "error" in out else 200)

        def log_message(self, fmt, *args):
            print(f"[serve] {self.address_string()} {fmt % args}")

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--demo", action="store_true",
                   help="random-weight reduced-width registry of the four families "
                        "(the only registry ported so far)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    p.add_argument("--max-batch", type=int, default=0,
                   help="micro-batch concurrent requests up to this size "
                        "(serve/batching.py); 0 = one forward per request")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to serve on the CPU)")
    if not args.demo:
        raise SystemExit("only --demo is ported so far (checkpoints come later)")
    engine = build_demo_engine(device)
    if args.max_batch > 1:
        from image_segmentation_tpu_torch.serve.batching import BatchingEngine

        engine = BatchingEngine(engine, max_batch=args.max_batch)
        t0 = time.time()
        engine.warmup()
        print(f"[serve] request batching on (max_batch={args.max_batch}); warm-up of "
              f"every batch size took {time.time() - t0:.1f} s")
    server = ThreadingHTTPServer((args.host, args.port), make_handler(engine))
    print(f"[serve] listening on http://{args.host}:{args.port} "
          f"models={engine.available()} device={device}")
    server.serve_forever()


if __name__ == "__main__":
    main()
