"""HTTP serving app for the port (stdlib http.server).

Counterpart of image_segmentation_tpu/serve/app.py:
  GET  /            — the interactive frontend (templates/index.html)
  GET  /static/*    — its assets (static/script.js, static/style.css)
  GET  /models      — registry listing
  POST /segment     — JSON {image: b64, model: name, [prompt_type,
                      prompt_data], [label: b64]} →
                      {output_mask: b64 PNG, [output_label: b64 PNG], class_names}

Prompt models take `prompt_type` ("points" by default, "bbox",
"scribble", "text") and `prompt_data` (a list of {x, y}; {x, y, width,
height}; a base64 PNG of the strokes); malformed prompt data is the
client's error (400). Uploads decode with PIL where it is installed,
else with the port's own PNG codec, which refuses JPEG (`data/png.py`
`decode`); masks are written by that codec.

Registries:
  * `--models-dir DIR`: the trained `MO_<config>` directories that
    `image_segmentation_tpu_torch.run` (or `utils/convert_reference_weights.py`)
    writes, at full width (`FAMILY_SPECS`): unet = UNet-64 at 256 px,
    autoencoder at 256 px, clip = the ViT-B/16 ClipUNet at 224 px (or the
    ClipUNetNoSkips of `MO_clipunet_noskips`), prompt_model at 224 px;
  * `--exports-dir DIR`: the `.istpt` programs of `serve/export.py`,
    which need no model code; combinable with `--models-dir`. A program
    serves the device type it was exported on and no other;
  * neither, or `--demo`: the JAX package's four random-weight families
    at its demo widths where the kernels allow (`demo_model_specs`):
    unet and autoencoder at base 8; clip and prompt_model with a ViT of
    hidden 128, MLP 256 and 2 heads (head dim 64, so on CUDA K3 and K4
    run), the selection UNet at base 8; all at 64 px.
The prompt family of a live registry is always composed
(`InferenceEngine.register_prompt_composed`). On CUDA the models compute
in bfloat16 with the hand-written kernels, on the CPU in float32 with
their plain versions. `--device` is explicit: cuda by default, and the
server refuses to start when there is none. With `--max-batch N` requests
are micro-batched (`serve/batching.py`) after a warm-up of every batch
size. `--mesh` is not ported.

Run: python -m image_segmentation_tpu_torch.serve.app [--models-dir DIR]
     [--exports-dir DIR] [--demo] [--device cpu] [--max-batch 4] [--port 8000]
"""
from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import os
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from image_segmentation_tpu_torch.config import (
    AUTOENCODER,
    CLIPUNET,
    CLIPUNET_NOSKIPS,
    PROMPT,
    UNET_AUG,
    UNET_NOAUG,
    ExperimentConfig,
    build_model,
)
from image_segmentation_tpu_torch.data import png
from image_segmentation_tpu_torch.data.dataset import normalize_image_channels
from image_segmentation_tpu_torch.data.labels import colorize_mask, target_remap
from image_segmentation_tpu_torch.models.clip_vit import ClipViTConfig
from image_segmentation_tpu_torch.serve.engine import InferenceEngine
from image_segmentation_tpu_torch.serve.render import create_prompt_mask

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")
TEMPLATE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "templates")

STATIC_TYPES = {".js": "application/javascript", ".css": "text/css", ".html": "text/html"}

DEMO_VIT = ClipViTConfig(image_size=64, patch_size=16, hidden_size=128,
                         num_layers=3, num_heads=2, mlp_dim=256)
DEMO_TARGET = 64


def _strip_data_url(data: str) -> bytes:
    if "," in data[:64] and data.lstrip().startswith("data:"):
        data = data.split(",", 1)[1]
    return base64.b64decode(data)


def decode_base64_image(data: str) -> np.ndarray:
    """b64 (optionally a data URL) → (H, W, 3) float32 in [0, 1], alpha dropped."""
    arr = normalize_image_channels(png.decode(_strip_data_url(data)))
    return arr.astype(np.float32) / 255.0


def decode_base64_gray(data: str) -> np.ndarray:
    """b64 (optionally a data URL) → (H, W) uint8, PIL's convert("L")."""
    return png.to_gray(png.decode(_strip_data_url(data)))


def encode_png_base64(arr: np.ndarray) -> str:
    return base64.b64encode(png.encode_png(arr)).decode("ascii")


def demo_model_specs(device, seed: int = 0, only: Optional[str] = None):
    """(name, model, target_size, needs_prompt) for the random-weight,
    reduced-width families of the JAX demo registry (app.py:99-143), each
    seeded from `seed`, in eval mode on `device`; `only` skips the others."""
    clip_kw = dict(vit=DEMO_VIT, skip_indices=(0, 1, 2, 3), decoder_channels=(64, 32, 16, 8, 8))
    builders = {
        "unet": (UNET_NOAUG, dict(base=8), False),
        "autoencoder": (AUTOENCODER, dict(base=8), False),
        "clip": (CLIPUNET, clip_kw, False),
        "prompt_model": (PROMPT, dict(clip_kw, unet_base=8), True),
    }
    for name, (cfg, kw, needs_prompt) in builders.items():
        if only and name != only:
            continue
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


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """A served family: its target size, whether it takes a prompt, and the
    `MO_` directories it is served from, in the order they are tried, each
    with the config its model is built as."""

    target_size: int
    needs_prompt: bool
    candidates: tuple


# The full-width families and JAX's candidate names and order
# (app.py:185-204): the serving alias, then every config that writes an
# MO_<config.name> (train/loop.py `fit`). MO_clipunet_noskips is built as
# the ClipUNetNoSkips it was trained as; JAX builds a ClipUNet for it and
# fails to load it.
FAMILY_SPECS = {
    "unet": FamilySpec(256, False, (("MO_unet", UNET_NOAUG), ("MO_unet_aug", UNET_AUG),
                                    ("MO_unet_noaug", UNET_NOAUG))),
    "autoencoder": FamilySpec(256, False, (("MO_autoencoder", AUTOENCODER),)),
    "clip": FamilySpec(224, False, (("MO_clip", CLIPUNET), ("MO_clipunet", CLIPUNET),
                                    ("MO_clipunet_noskips", CLIPUNET_NOSKIPS))),
    "prompt_model": FamilySpec(224, True, (("MO_prompt_model", PROMPT), ("MO_prompt", PROMPT))),
}


def load_family_model(path: str, cfg: ExperimentConfig, device) -> torch.nn.Module:
    """The config's model in eval mode on `device`, holding the trained
    state of the checkpoint at `path` (an `MO_` directory or a full
    checkpoint): parameters and BatchNorm running statistics, loaded
    strictly, so a missing statistic raises instead of serving init ones."""
    from image_segmentation_tpu_torch.train.checkpoint import load_model_state

    model = build_model(cfg, device, torch.Generator().manual_seed(cfg.seed))
    model.load_state_dict(load_model_state(path, device), strict=True)
    return model


def find_checkpoint(models_dir: str, name: str):
    """(path, config) of the first of family `name`'s candidate directories
    in `models_dir`, or None."""
    return next(((os.path.join(models_dir, c), cfg) for c, cfg in FAMILY_SPECS[name].candidates
                 if os.path.isdir(os.path.join(models_dir, c))), None)


def load_family_models(models_dir: str, device="cuda", only: Optional[str] = None):
    """(name, model, target_size, needs_prompt) for each family of
    `FAMILY_SPECS` with a checkpoint in `models_dir` (JAX app.py:171-222);
    the first candidate directory found wins. `only` skips the others."""
    for name, spec in FAMILY_SPECS.items():
        if only and name != only:
            continue
        found = find_checkpoint(models_dir, name)
        if found is None:
            tried = ", ".join(c for c, _ in spec.candidates)
            print(f"[serve] no checkpoint for {name} in {models_dir} (tried {tried}); skipping")
            continue
        path, cfg = found
        model = load_family_model(path, cfg, device)
        print(f"[serve] loaded {name} from {os.path.basename(path)} ({type(model).__name__})")
        yield name, model, spec.target_size, spec.needs_prompt


def build_engine_from_checkpoints(models_dir: str, device="cuda") -> InferenceEngine:
    """A registry of every family with a trained checkpoint in `models_dir`,
    on the card unless `device` says otherwise; raises when there is none."""
    eng = InferenceEngine(device=device)
    register_families(eng, load_family_models(models_dir, device))
    if not eng.models:
        raise RuntimeError(f"no model checkpoints found in {models_dir}")
    return eng


def register_exports(eng: InferenceEngine, exports_dir: str) -> list:
    """Register every program of `exports_dir` (serve/export.py); raises
    when there is none. Returns the registered names."""
    from image_segmentation_tpu_torch.serve.export import ARTIFACT_EXT

    if not os.path.isdir(exports_dir):
        raise SystemExit(f"--exports-dir {exports_dir!r} is not a directory")
    names = []
    for f in sorted(os.listdir(exports_dir)):
        if f.endswith(ARTIFACT_EXT):
            names.append(eng.register_exported(os.path.join(exports_dir, f)))
            print(f"[serve] loaded exported program {names[-1]} ({f})")
    if not names:
        raise SystemExit(f"no {ARTIFACT_EXT} programs in {exports_dir}")
    return names


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
        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, obj, code: int = 200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                with open(os.path.join(TEMPLATE_DIR, "index.html"), "rb") as f:
                    self._send(200, f.read(), "text/html")
            elif self.path == "/models":
                self._send_json({"models": engine.available()})
            elif self.path.startswith("/static/"):
                # JAX's guard (app.py:311-319): a path that normalises
                # outside static/ is not found
                full = os.path.normpath(os.path.join(STATIC_DIR, self.path[len("/static/"):]))
                if not full.startswith(STATIC_DIR + os.sep) or not os.path.isfile(full):
                    self._send_json({"error": "not found"}, 404)
                    return
                ctype = STATIC_TYPES.get(os.path.splitext(full)[1], "application/octet-stream")
                with open(full, "rb") as f:
                    self._send(200, f.read(), ctype)
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
    p.add_argument("--models-dir", default=None,
                   help="serve the trained MO_<config> checkpoints in this directory")
    p.add_argument("--exports-dir", default=None,
                   help="serve the exported programs (serve/export.py) in this directory, "
                        "with no model code; combinable with --models-dir")
    p.add_argument("--demo", action="store_true",
                   help="random-weight reduced-width registry of the four families "
                        "(also the registry when neither directory is given)")
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
    if args.exports_dir:
        engine = (build_engine_from_checkpoints(args.models_dir, device) if args.models_dir
                  else InferenceEngine(device=device))
        register_exports(engine, args.exports_dir)
    elif args.demo or not args.models_dir:
        print("[serve] demo mode: random-weight models")
        engine = build_demo_engine(device)
    else:
        engine = build_engine_from_checkpoints(args.models_dir, device)
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
