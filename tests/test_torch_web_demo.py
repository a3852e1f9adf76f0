"""The port's demo surfaces on the CPU (counterparts of the web-demo, gradio
and walkthrough tests of ``tests/test_product.py``):

- the stdlib web demo served with ``--tiny`` on port 0: ``/health``, the
  form, a ``/run`` whose edited video comes back through ``/file``, and a
  404 for any path a run did not register;
- ``build_demo``: ``ImportError`` without gradio; against a stub module, 11
  inputs and 1 output wired to ``run_headless``;
- the folded ``gradio_demo --variant`` and its two aliases make the same
  ``run_headless`` call;
- the walkthrough on tiny archs.
"""

import os
import sys
import threading
import types
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from anyv2v_torch.cli import gradio_demo, gradio_demo_cosxl, gradio_demo_style
from anyv2v_torch.product import gradio_app, walkthrough, web_demo
from anyv2v_torch.utils.io import save_video
from test_torch_seine import one_torch_thread  # noqa: F401 (fixture)


def _make_video(path, n=4, hw=64):
    save_video(np.random.RandomState(0).rand(n, hw, hw, 3).astype(np.float32), str(path), fps=4)


def test_web_demo_e2e(tmp_path):
    video = tmp_path / "v.mp4"
    _make_video(video)
    started = threading.Event()
    threading.Thread(target=web_demo.serve, daemon=True,
                     kwargs=dict(variant="instructpix2pix", port=0, tiny=True,
                                 started=started)).start()
    assert started.wait(30)
    httpd = web_demo._LAST_SERVER
    try:
        assert httpd.app.device == "cpu" and httpd.app.editor == "instructpix2pix-tiny"
        base = f"http://127.0.0.1:{httpd.server_port}"
        with urllib.request.urlopen(base + "/health", timeout=10) as r:
            assert b'"ok": true' in r.read()
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            page = r.read().decode()
        assert "Run AnyV2V" in page and "Temporal injection" in page

        form = urllib.parse.urlencode({
            "video_path": str(video), "prompt": "a snowy scene",
            "instruct_prompt": "make it snowy",
            "ddim_inversion_steps": 10, "num_inference_steps": 5,
        }).encode()
        req = urllib.request.Request(base + "/run", data=form, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            result = r.read().decode()
        assert "Done" in result, result[:2000]
        out = httpd.app.last["edited_video"]
        assert os.path.exists(out) and out.endswith("edited_video.mp4")

        with urllib.request.urlopen(base + "/file?path=" + urllib.parse.quote(out),
                                    timeout=10) as r:
            assert r.headers["Content-Type"] == "video/mp4" and len(r.read()) > 0
        for path in ("/etc/hosts", os.path.join(os.path.dirname(out), "..", "v.mp4")):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(base + "/file?path=" + urllib.parse.quote(path),
                                       timeout=10)
            assert err.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_build_demo_raises_without_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)   # import gradio -> ImportError
    with pytest.raises(ImportError, match="gradio"):
        gradio_app.build_demo("instructpix2pix")


class _Component:
    def __init__(self, *a, **kw):
        self.args, self.kwargs = a, kw


class _Blocks(_Component):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Markdown(_Component):
    texts = []

    def __init__(self, text, **kw):
        super().__init__(text, **kw)
        _Markdown.texts.append(text)


class _Button(_Component):
    last = None

    def click(self, fn, inputs=None, outputs=None):
        _Button.last = dict(fn=fn, inputs=inputs, outputs=outputs)


def _stub_gradio(monkeypatch):
    gr = types.ModuleType("gradio")
    gr.Blocks, gr.Row, gr.Accordion, gr.Button = _Blocks, _Blocks, _Blocks, _Button
    gr.Markdown = _Markdown
    gr.Video = gr.Textbox = gr.Slider = gr.Number = _Component
    monkeypatch.setitem(sys.modules, "gradio", gr)


@pytest.mark.parametrize("variant", ["instructpix2pix", "style"])
def test_build_demo_wires_run_headless(monkeypatch, variant):
    """The Blocks graph builds against a structural stub; the button takes
    11 inputs and gives 1 output, and its handler calls run_headless with
    the sliders' values as numbers, the variant and the device."""
    _stub_gradio(monkeypatch)
    _Markdown.texts.clear()
    demo = gradio_app.build_demo(variant, device="cpu")
    assert isinstance(demo, _Blocks)
    assert _Markdown.texts[0] == f"# AnyV2V — GPU ({variant})"
    assert _Markdown.texts[-1] == f"Max length: {128 if variant == 'style' else 16} frames."
    wired = _Button.last
    assert len(wired["inputs"]) == 11 and len(wired["outputs"]) == 1
    seen = {}

    def fake_run_headless(video, p, ip, **kw):
        seen.update(kw, video=video)
        return "out.mp4"

    monkeypatch.setattr(gradio_app, "run_headless", fake_run_headless)
    assert wired["fn"]("v.mp4", "prompt", "instruction", "", 50, 9.0, 1,
                       0.2, 0.2, 0.5, 42) == "out.mp4"
    assert seen["num_inference_steps"] == 50 and seen["seed"] == 42
    assert seen["variant"] == variant and seen["device"] == "cpu"


@pytest.mark.parametrize("variant,alias", [("cosxl", gradio_demo_cosxl),
                                           ("style", gradio_demo_style)])
def test_gradio_demo_aliases_make_the_folded_call(monkeypatch, capsys, variant, alias):
    calls = []

    def fake_run_headless(*a, **kw):
        calls.append((a, kw))
        return "edited_video.mp4"

    monkeypatch.setattr(gradio_app, "run_headless", fake_run_headless)
    argv = ["--headless", "--video_path", "v.mp4", "--prompt", "p", "--instruct_prompt", "i",
            "--arch", "i2vgen-tiny", "--editor_arch_suffix=-tiny", "--device", "cpu",
            "--num_inference_steps", "5", "--ddim_inversion_steps", "10"]
    gradio_demo.main(["--variant", variant] + argv)
    alias.main(argv)
    assert len(calls) == 2 and calls[0] == calls[1]
    args, kw = calls[0]
    assert args == ("v.mp4", "p", "i") and kw["variant"] == variant
    assert kw["editor"] == gradio_app.EDITOR_FOR_VARIANT[variant] + "-tiny"
    assert kw["device"] == "cpu" and kw["runner_kwargs"]["dtype"] == "float32"
    assert capsys.readouterr().out.splitlines() == ["edited_video.mp4"] * 2


def test_gradio_demo_web_serves_the_variant(monkeypatch):
    seen = {}
    monkeypatch.setattr(web_demo, "serve", lambda variant, **kw: seen.update(kw, v=variant))
    gradio_demo_style.main(["--web", "--tiny", "--server_port", "0"])
    assert seen == {"v": "style", "port": 0, "tiny": True, "device": "cuda"}


def test_walkthrough_runs_on_tiny_archs(tmp_path):
    out = walkthrough.main([str(tmp_path / "demo_out"), "--device", "cpu"])
    assert out == str(tmp_path / "demo_out" / "edited_video.mp4") and os.path.exists(out)
    names = sorted(os.listdir(tmp_path / "demo_out"))
    assert names == ["edited_first_frame.png", "edited_video.mp4", "source.mp4"]
