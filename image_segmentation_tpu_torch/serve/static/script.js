// Frontend for the TPU segmentation demo.
// Beyond the reference webapp frontend (which shipped points only,
// segmentation_webapp/static/script.js:36-37), this UI exercises all
// three prompt types the serving API renders (serve/render.py):
//   point    — click (circles r20 + Gaussian blur r10 server-side)
//   bbox     — drag a rectangle
//   scribble — freehand strokes, shipped as a grayscale mask image
// All prompt coordinates are in ORIGINAL image pixels (the canvas's
// intrinsic size; CSS scaling is undone per event).

const COLORS = ["#000000", "#ff0000", "#00ff00", "#0000ff"];

const state = {
  imageDataUrl: null,
  labelDataUrl: null,
  mode: "point", // point | bbox | scribble
  point: null, // {x, y} original coords
  bbox: null, // {x, y, width, height} original coords
  drag: null, // in-progress bbox drag {x0, y0, x1, y1}
  scribbling: false,
  scribble: null, // offscreen canvas at original size, white strokes
  model: null,
};

const canvas = document.getElementById("input-canvas");
const ctx = canvas.getContext("2d");
const statusEl = document.getElementById("status");
const segmentBtn = document.getElementById("segment-btn");

async function loadModels() {
  const res = await fetch("/models");
  const data = await res.json();
  const fs = document.getElementById("model-choices");
  data.models.forEach((name, i) => {
    const label = document.createElement("label");
    const input = document.createElement("input");
    input.type = "radio";
    input.name = "model";
    input.value = name;
    if (i === 0) {
      input.checked = true;
      state.model = name;
    }
    input.addEventListener("change", () => (state.model = name));
    label.appendChild(input);
    label.appendChild(document.createTextNode(" " + name));
    fs.appendChild(label);
  });
}

document.querySelectorAll('input[name="prompt-mode"]').forEach((el) => {
  el.addEventListener("change", () => {
    state.mode = el.value;
    redraw();
  });
});

function clearPrompts() {
  state.point = null;
  state.bbox = null;
  state.drag = null;
  state.scribble = null;
  state.scribbling = false;
}

function drawPrompt() {
  const r = Math.max(4, canvas.width / 60);
  if (state.point) {
    ctx.fillStyle = "rgba(255, 215, 0, 0.9)";
    ctx.beginPath();
    ctx.arc(state.point.x, state.point.y, r, 0, 2 * Math.PI);
    ctx.fill();
    ctx.strokeStyle = "#333";
    ctx.stroke();
  }
  const box = state.drag
    ? {
        x: Math.min(state.drag.x0, state.drag.x1),
        y: Math.min(state.drag.y0, state.drag.y1),
        width: Math.abs(state.drag.x1 - state.drag.x0),
        height: Math.abs(state.drag.y1 - state.drag.y0),
      }
    : state.bbox;
  if (box) {
    ctx.strokeStyle = "rgba(255, 215, 0, 0.95)";
    ctx.lineWidth = Math.max(2, canvas.width / 200);
    ctx.strokeRect(box.x, box.y, box.width, box.height);
    ctx.fillStyle = "rgba(255, 215, 0, 0.15)";
    ctx.fillRect(box.x, box.y, box.width, box.height);
  }
  if (state.scribble) {
    ctx.save();
    ctx.globalAlpha = 0.55;
    ctx.drawImage(state.scribble, 0, 0);
    ctx.restore();
  }
}

function redraw() {
  if (!state.imageDataUrl) return;
  const img = new Image();
  img.onload = () => {
    state.imageW = img.naturalWidth;
    state.imageH = img.naturalHeight;
    canvas.width = img.naturalWidth;
    canvas.height = img.naturalHeight;
    ctx.drawImage(img, 0, 0);
    drawPrompt();
  };
  img.src = state.imageDataUrl;
}

document.getElementById("image-input").addEventListener("change", (e) => {
  const file = e.target.files[0];
  if (!file) return;
  const reader = new FileReader();
  reader.onload = () => {
    state.imageDataUrl = reader.result;
    clearPrompts();
    segmentBtn.disabled = false;
    redraw();
  };
  reader.readAsDataURL(file);
});

document.getElementById("label-input").addEventListener("change", (e) => {
  const file = e.target.files[0];
  if (!file) return;
  const reader = new FileReader();
  reader.onload = () => (state.labelDataUrl = reader.result);
  reader.readAsDataURL(file);
});

// Event → original-image coordinates (canvas displayed scaled via CSS;
// intrinsic size = original image size).
function canvasCoords(e) {
  const rect = canvas.getBoundingClientRect();
  return {
    x: Math.round(((e.clientX - rect.left) / rect.width) * canvas.width),
    y: Math.round(((e.clientY - rect.top) / rect.height) * canvas.height),
  };
}

function scribbleCtx() {
  if (!state.scribble) {
    state.scribble = document.createElement("canvas");
    state.scribble.width = canvas.width;
    state.scribble.height = canvas.height;
    const sctx = state.scribble.getContext("2d");
    // black background: the server binarises grayscale > 10/255
    sctx.fillStyle = "#000000";
    sctx.fillRect(0, 0, canvas.width, canvas.height);
  }
  return state.scribble.getContext("2d");
}

canvas.addEventListener("mousedown", (e) => {
  if (!state.imageDataUrl) return;
  const p = canvasCoords(e);
  if (state.mode === "point") {
    state.point = p;
    state.bbox = null;
    state.scribble = null;
    redraw();
  } else if (state.mode === "bbox") {
    state.drag = { x0: p.x, y0: p.y, x1: p.x, y1: p.y };
    state.point = null;
    state.scribble = null;
  } else if (state.mode === "scribble") {
    state.scribbling = true;
    state.point = null;
    state.bbox = null;
    const sctx = scribbleCtx();
    sctx.strokeStyle = "#ffffff";
    sctx.lineWidth = Math.max(6, canvas.width / 40);
    sctx.lineCap = "round";
    sctx.lineJoin = "round";
    sctx.beginPath();
    sctx.moveTo(p.x, p.y);
  }
});

canvas.addEventListener("mousemove", (e) => {
  if (state.mode === "bbox" && state.drag) {
    const p = canvasCoords(e);
    state.drag.x1 = p.x;
    state.drag.y1 = p.y;
    redraw();
  } else if (state.mode === "scribble" && state.scribbling) {
    const p = canvasCoords(e);
    const sctx = scribbleCtx();
    sctx.lineTo(p.x, p.y);
    sctx.stroke();
    redraw();
  }
});

function endStroke(e) {
  if (state.mode === "bbox" && state.drag) {
    const d = state.drag;
    state.bbox = {
      x: Math.min(d.x0, d.x1),
      y: Math.min(d.y0, d.y1),
      width: Math.abs(d.x1 - d.x0),
      height: Math.abs(d.y1 - d.y0),
    };
    state.drag = null;
    redraw();
  }
  state.scribbling = false;
}
canvas.addEventListener("mouseup", endStroke);
canvas.addEventListener("mouseleave", endStroke);

document.getElementById("clear-btn").addEventListener("click", () => {
  clearPrompts();
  redraw();
});

function renderLegend(classNames) {
  const el = document.getElementById("legend");
  el.innerHTML = "";
  classNames.forEach((name, i) => {
    const item = document.createElement("span");
    item.className = "legend-item";
    const sw = document.createElement("span");
    sw.className = "legend-swatch";
    sw.style.background = COLORS[i % COLORS.length];
    item.appendChild(sw);
    item.appendChild(document.createTextNode(name));
    el.appendChild(item);
  });
}

function promptPayload() {
  if (state.point) return { prompt_type: "points", prompt_data: [state.point] };
  if (state.bbox && state.bbox.width > 0 && state.bbox.height > 0)
    return { prompt_type: "bbox", prompt_data: state.bbox };
  if (state.scribble)
    return {
      prompt_type: "scribble",
      prompt_data: state.scribble.toDataURL("image/png"),
    };
  return null;
}

segmentBtn.addEventListener("click", async () => {
  if (!state.imageDataUrl || !state.model) return;
  statusEl.textContent = "segmenting…";
  segmentBtn.disabled = true;
  const payload = {
    image: state.imageDataUrl,
    model: state.model,
  };
  const prompt = promptPayload();
  if (prompt) Object.assign(payload, prompt);
  if (state.labelDataUrl) payload.label = state.labelDataUrl;
  try {
    const res = await fetch("/segment", {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify(payload),
    });
    const data = await res.json();
    if (data.error) {
      statusEl.textContent = "error: " + data.error;
      return;
    }
    document.getElementById("output-mask").src =
      "data:image/png;base64," + data.output_mask;
    if (data.output_label) {
      document.getElementById("output-label").src =
        "data:image/png;base64," + data.output_label;
    }
    renderLegend(data.class_names);
    statusEl.textContent = "done";
  } catch (err) {
    statusEl.textContent = "request failed: " + err;
  } finally {
    segmentBtn.disabled = false;
  }
});

loadModels();
