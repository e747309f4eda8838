"""HTTP serving app for the port (stdlib http.server).

Counterpart of image_segmentation_tpu/serve/app.py, for the clip family:
  GET  /models   — registry listing
  POST /segment  — JSON {image: b64, model: name, [label: b64]} →
                   {output_mask: b64 PNG, [output_label: b64 PNG], class_names}

Uploads decode and masks encode with PIL. `--demo` serves a random-weight
ClipUNet at reduced widths (hidden 128, MLP 256, so on CUDA both kernels
run); on CUDA it computes in bfloat16 with the hand-written kernels, on
the CPU in float32 with their plain versions. The interactive frontend,
prompt families, checkpoints and AOT artifacts come with later slices.

Run: python -m image_segmentation_tpu_torch.serve.app --demo [--port 8000]
"""
from __future__ import annotations

import argparse
import base64
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from image_segmentation_tpu_torch.config import CLIPUNET, build_model
from image_segmentation_tpu_torch.data.dataset import normalize_image_channels
from image_segmentation_tpu_torch.data.labels import colorize_mask, target_remap
from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig
from image_segmentation_tpu_torch.serve.engine import InferenceEngine

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


def build_demo_engine(device="cpu", seed: int = 0) -> InferenceEngine:
    """A registry with one random-weight, reduced-width clip family."""
    model = build_model(
        CLIPUNET, device, torch.Generator().manual_seed(seed), vit=DEMO_VIT,
        skip_indices=(0, 1, 2, 3), decoder_channels=(64, 32, 16, 8, 8))
    eng = InferenceEngine(device=device)
    eng.register("clip", model, DEMO_TARGET)
    return eng


def handle_segment(engine: InferenceEngine, payload: dict) -> dict:
    """Core of POST /segment."""
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

    result = engine.segment(image, model_name)
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
                   help="random-weight reduced-width clip family (the only "
                        "registry this slice has)")
    args = p.parse_args(argv)
    if not args.demo:
        raise SystemExit("only --demo is ported so far (checkpoints come later)")
    device = "cuda" if torch.cuda.is_available() else "cpu"
    engine = build_demo_engine(device)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(engine))
    print(f"[serve] listening on http://{args.host}:{args.port} "
          f"models={engine.available()} device={device}")
    server.serve_forever()


if __name__ == "__main__":
    main()
