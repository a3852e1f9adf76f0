"""Web demo without gradio (counterpart of ``anyv2v_tpu/product/web_demo.py``):
the reference's gradio surface on the standard library's ``http.server``.

It serves the three-stage flow of the reference's demos
(``gradio_demo.py:278-379`` and the style / cosxl variants: preprocess the
video, edit its first frame, run AnyV2V) through
:func:`.gradio_app.run_headless`, with a form of the demo's controls and
defaults (``gradio_app.DEFAULTS``), for machines without gradio.

Usage:
    python -m anyv2v_torch.product.web_demo [--variant instructpix2pix]
        [--port 7860] [--device cuda] [--tiny]

``--tiny`` builds random-weight tiny pipelines on the CPU in fp32, so that
the whole flow runs without checkpoints or a GPU. Requests run one at a time
(one device, one run); a run's output files, and nothing else, are
served back.
"""

from __future__ import annotations

import argparse
import html
import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .gradio_app import DEFAULTS, EDITOR_FOR_VARIANT

_FORM = """<!doctype html>
<html><head><title>AnyV2V ({variant})</title>
<style>
 body {{ font-family: sans-serif; max-width: 46rem; margin: 2rem auto; }}
 label {{ display: block; margin-top: .7rem; }}
 input[type=text], input[type=number] {{ width: 100%; }}
 .row {{ display: flex; gap: 1rem; }} .row label {{ flex: 1; }}
 button {{ margin-top: 1rem; padding: .5rem 1.5rem; }}
 pre {{ background: #f4f4f4; padding: 1rem; overflow-x: auto; }}
</style></head><body>
<h1>AnyV2V &mdash; {variant}</h1>
<p>Three stages (reference <code>gradio_demo.py</code>): preprocess the
video, edit its first frame with <b>{editor}</b>, then invert + re-sample
with PnP injection.</p>
<form method="post" action="/run">
<label>Video path (on this machine)
  <input type="text" name="video_path" required value="{video_path}"></label>
<label>Video prompt
  <input type="text" name="prompt" value="{prompt}"></label>
<label>First-frame edit instruction
  <input type="text" name="instruct_prompt" value="{instruct_prompt}"></label>
<label>Negative prompt
  <input type="text" name="negative_prompt" value=""></label>
<div class="row">
<label>Inversion steps
  <input type="number" name="ddim_inversion_steps" value="{ddim_inversion_steps}"></label>
<label>Sampling steps
  <input type="number" name="num_inference_steps" value="{num_inference_steps}"></label>
<label>CFG
  <input type="number" step="0.5" name="guidance_scale" value="{guidance_scale}"></label>
<label>t_idx
  <input type="number" name="ddim_init_latents_t_idx" value="{ddim_init_latents_t_idx}"></label>
</div>
<div class="row">
<label>Conv injection
  <input type="number" step="0.05" name="conv_inj" value="{conv_inj}"></label>
<label>Spatial injection
  <input type="number" step="0.05" name="spatial_inj" value="{spatial_inj}"></label>
<label>Temporal injection
  <input type="number" step="0.05" name="temp_inj" value="{temp_inj}"></label>
<label>Seed
  <input type="number" name="seed" value="{seed}"></label>
</div>
<button type="submit">Run AnyV2V</button>
</form>
{result}
</body></html>
"""

_LAST_SERVER = None   # the most recent server (test hook)

_FLOAT_FIELDS = ("guidance_scale", "conv_inj", "spatial_inj", "temp_inj")
_INT_FIELDS = ("ddim_inversion_steps", "num_inference_steps",
               "ddim_init_latents_t_idx", "seed")


class _App:
    """One demo app: variant + fixed runner/editor kwargs, a run lock, and
    the registry of output files this server is allowed to serve."""

    def __init__(self, variant: str, runner_kwargs=None, editor_kwargs=None,
                 overrides=None, editor=None, device="cuda"):
        self.variant = variant
        self.device = device
        self.runner_kwargs = runner_kwargs or {}
        self.editor_kwargs = editor_kwargs or {}
        self.overrides = overrides or {}
        self.editor = editor
        self.lock = threading.Lock()
        self.servable: set[str] = set()
        self.last: dict | None = None

    def run(self, form: dict) -> dict:
        from .gradio_app import run_headless

        params = dict(DEFAULTS)
        for k in _FLOAT_FIELDS:
            if form.get(k):
                params[k] = float(form[k][0] if isinstance(form[k], list)
                                  else form[k])
        for k in _INT_FIELDS:
            if form.get(k):
                params[k] = int(float(form[k][0] if isinstance(form[k], list)
                                      else form[k]))
        params.update(self.overrides)

        def f(name, default=""):
            v = form.get(name, default)
            return v[0] if isinstance(v, list) else v

        with self.lock:   # one device: one run at a time
            out = run_headless(
                f("video_path"), f("prompt"), f("instruct_prompt"),
                variant=self.variant,
                negative_prompt=f("negative_prompt"),
                runner_kwargs=self.runner_kwargs,
                editor_kwargs=self.editor_kwargs,
                editor=self.editor,
                device=self.device,
                **params,
            )
        out_dir = os.path.dirname(os.path.abspath(out))
        rec = {"edited_video": os.path.abspath(out), "out_dir": out_dir}
        for root, _, names in os.walk(out_dir):
            for n in names:
                self.servable.add(os.path.abspath(os.path.join(root, n)))
        self.last = rec
        return rec


def _mime(path: str) -> str:
    return {".mp4": "video/mp4", ".gif": "image/gif", ".png": "image/png",
            ".jpg": "image/jpeg", ".yaml": "text/plain",
            ".json": "application/json"}.get(
                os.path.splitext(path)[1].lower(), "application/octet-stream")


def make_handler(app: _App):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _page(self, result_html=""):
            body = _FORM.format(
                variant=html.escape(app.variant),
                editor=html.escape(EDITOR_FOR_VARIANT.get(app.variant,
                                                          app.variant)),
                video_path="", prompt="", instruct_prompt="",
                result=result_html,
                **{k: DEFAULTS[k] for k in (*_INT_FIELDS, *_FLOAT_FIELDS)},
            ).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/":
                return self._page()
            if parsed.path == "/health":
                body = json.dumps({"ok": True,
                                   "variant": app.variant}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parsed.path == "/file":
                q = urllib.parse.parse_qs(parsed.query)
                path = os.path.abspath(q.get("path", [""])[0])
                # serve ONLY files a finished run registered — no traversal
                if path not in app.servable:
                    self.send_error(404, "not a registered output file")
                    return
                with open(path, "rb") as fh:
                    data = fh.read()
                self.send_response(200)
                self.send_header("Content-Type", _mime(path))
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            self.send_error(404)

        def do_POST(self):
            if self.path != "/run":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", "0"))
            form = urllib.parse.parse_qs(self.rfile.read(n).decode())
            try:
                rec = app.run(form)
            except Exception as e:  # surface the error in the page
                err = html.escape(f"{type(e).__name__}: {e}")
                return self._page(f"<h2>Run failed</h2><pre>{err}</pre>")
            link = urllib.parse.quote(rec["edited_video"])
            self._page(
                "<h2>Done</h2><pre>" + html.escape(json.dumps(rec, indent=1))
                + "</pre>"
                + f'<p><a href="/file?path={link}">edited video</a></p>')

    return Handler


def serve(variant="instructpix2pix", port=7860, tiny=False, host="127.0.0.1",
          started: "threading.Event | None" = None, device="cuda"):
    """Run the demo server (blocking) on ``device``. ``tiny`` wires random
    tiny pipelines on the CPU in fp32, so the flow runs end to end without
    checkpoints."""
    kwargs = {"device": device}
    if tiny:
        # the tiny-arch wiring the headless product tests use
        kwargs = dict(
            runner_kwargs=dict(arch="i2vgen-tiny", dtype="float32"),
            editor=EDITOR_FOR_VARIANT.get(variant, variant) + "-tiny",
            overrides=dict(ddim_inversion_steps=10, num_inference_steps=5,
                           image_edit_steps=2),
            device="cpu",
        )
    global _LAST_SERVER
    app = _App(variant, **kwargs)
    httpd = ThreadingHTTPServer((host, port), make_handler(app))
    httpd.app = app  # tests reach the run registry through the server
    _LAST_SERVER = httpd
    if started is not None:
        started.set()
    print(f"AnyV2V web demo ({variant}) on http://{host}:{httpd.server_port}",
          flush=True)
    httpd.serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--variant", default="instructpix2pix",
                    choices=sorted(EDITOR_FOR_VARIANT))
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="random tiny pipelines on the CPU (no checkpoints)")
    args = ap.parse_args(argv)
    serve(args.variant, args.port, args.tiny, args.host, device=args.device)


if __name__ == "__main__":
    main()
