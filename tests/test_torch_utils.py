"""The port's own copies of the host-side utilities against the JAX package's
``anyv2v_tpu/utils`` originals, on the same seeded inputs: the CLIP
tokenizer, the config system (group configs, dotlists, interpolation), the
reconstruction metrics and the image/frame IO the CLI shells use. The copies
compute the same thing, so results are compared exactly."""

import json

import numpy as np
import pytest
from PIL import Image

from anyv2v_torch.utils import config as tcfg
from anyv2v_torch.utils import io as tio
from anyv2v_torch.utils import metrics as tmet
from anyv2v_torch.utils.tokenizer import CLIPTokenizer
from anyv2v_tpu.utils import config as jcfg
from anyv2v_tpu.utils import io as jio
from anyv2v_tpu.utils import metrics as jmet
from anyv2v_tpu.utils.tokenizer import CLIPTokenizer as JCLIPTokenizer


def _bpe_files(root):
    """A tiny character vocabulary with a few merges, in the checkpoint's
    vocab.json / merges.txt format."""
    vocab = {}
    for c in "abcdefghijklmnopqrstuvwxyz ,.!":
        vocab.setdefault(c, len(vocab))
        vocab.setdefault(c + "</w>", len(vocab))
    merges = ["t h", "th e</w>", "a n", "an d</w>", "c a", "ca t</w>"]
    for m in merges:
        vocab.setdefault(m.replace(" ", ""), len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(root / "vocab.json"), str(root / "merges.txt")


@pytest.mark.parametrize("text", ["the cat and the hat.", "a man, walking!", "",
                                  "a very long prompt that runs past the sixteen token limit"])
def test_tokenizer_matches_jax(tmp_path, text):
    files = _bpe_files(tmp_path)
    got = CLIPTokenizer(*files, max_length=16)([text])
    want = JCLIPTokenizer(*files, max_length=16)([text])
    assert got.shape == (1, 16)
    np.testing.assert_array_equal(got, want)


TEMPLATE = """
seed: 8888
model: {arch: "i2vgen-xl", dtype: "bfloat16"}
video_name: "ReplaceMe"
output_dir: "results/${video_name}"
inverse_config:
  n_steps: 500
  output_dir: "${output_dir}/ddim_latents"
  steps: ${inverse_config.n_steps}
"""


def test_config_matches_jax(tmp_path):
    (tmp_path / "template.yaml").write_text(TEMPLATE)
    (tmp_path / "group.json").write_text(json.dumps([
        {"video_name": "square", "inverse_config": {"n_steps": 10}},
        {"video_name": "skip", "active": False},
        {"video_name": "circle", "model": {"dtype": "float32"}},
    ]))
    paths = str(tmp_path / "template.yaml"), str(tmp_path / "group.json")
    got, want = tcfg.load_group_configs(*paths), jcfg.load_group_configs(*paths)
    assert got == want and [c.video_name for c in got] == ["square", "circle"]
    assert got[0].inverse_config.output_dir == "results/square/ddim_latents"
    assert got[0].inverse_config.steps == 10

    dotlist = ["inverse_config.n_steps=25", "image_size=[64,64]", "model.init=", "seed=3"]
    got = tcfg.resolve(tcfg.merge(tcfg.load_yaml(paths[0]), tcfg.from_dotlist(dotlist)))
    want = jcfg.resolve(jcfg.merge(jcfg.load_yaml(paths[0]), jcfg.from_dotlist(dotlist)))
    assert got == want
    assert got.inverse_config.steps == 25 and got.image_size == [64, 64]
    assert got.model.init is None and got.model.arch == "i2vgen-xl"


def test_metrics_match_jax():
    rng = np.random.RandomState(4)
    src = rng.rand(3, 24, 20, 3).astype(np.float32)
    recon = np.clip(src + 0.05 * rng.randn(*src.shape), 0, 1).astype(np.float32)
    assert tmet.psnr(recon, src) == jmet.psnr(recon, src)
    assert tmet.video_report(recon, src) == jmet.video_report(recon, src)
    assert tmet.psnr(src, src) == float("inf")


def test_image_io_matches_jax(tmp_path):
    rng = np.random.RandomState(5)
    frames = [Image.fromarray(rng.randint(0, 256, (36, 48, 3), np.uint8)) for _ in range(3)]
    for img in frames:
        np.testing.assert_array_equal(np.asarray(tio.center_crop_wide(img, (32, 32))),
                                      np.asarray(jio.center_crop_wide(img, (32, 32))))
    np.testing.assert_array_equal(tio.frames_to_array01(frames), jio.frames_to_array01(frames))
    video = tio.frames_to_array01(frames)
    tio.save_frames(video, str(tmp_path / "frames"))
    got = tio.load_video_frames(str(tmp_path / "frames"), 3, (24, 18))
    want = jio.load_video_frames(str(tmp_path / "frames"), 3, (24, 18))
    np.testing.assert_array_equal(tio.frames_to_array01(got), jio.frames_to_array01(want))
    np.testing.assert_array_equal(tio.frames_to_array01(tio.load_video_frames(
        str(tmp_path / "frames"), 3)), video)
    with pytest.raises(FileNotFoundError):
        tio.load_video_frames(str(tmp_path / "frames"), 4)
