"""Video preparation and camera motion in the port against the JAX package
(``anyv2v_torch/utils/video_prep.py``, ``cli/prepare_video.py``,
``utils/camera.py``), on the CPU: host code on OpenCV and PIL, which both
packages call the same way, so every frame must be bit-equal.

A synthetic clip (2 s at 24 fps, 96x80, a square drifting over gradients)
is written with OpenCV; ``crop_and_resize_video`` runs in four cases (a
start time with a duration, a centre crop with offsets, the longest side to
the width, the full clip), and the two packages' output files are decoded
and compared frame by frame, as are ``extract_frames`` and the four camera
motions.
"""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

from anyv2v_tpu.utils import camera as jcamera
from anyv2v_tpu.utils import video_prep as jprep
from anyv2v_torch.cli import prepare_video
from anyv2v_torch.utils import camera, video_prep

FPS, N, W, H = 24, 48, 96, 80


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("video_prep")
    path = str(root / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS, (W, H))
    yy, xx = np.mgrid[0:H, 0:W]
    for i in range(N):
        frame = np.zeros((H, W, 3), np.uint8)
        frame[..., 0] = (xx * 255 // W).astype(np.uint8)
        frame[..., 1] = (yy * 255 // H).astype(np.uint8)
        frame[20:40, 2 * i % W:(2 * i % W) + 16] = (250, 250, 30)
        writer.write(frame)
    writer.release()
    return root, path


CASES = {
    "start+duration": dict(clip_duration=1, start_time=0.5, width=64, height=48),
    "center_crop+offsets": dict(clip_duration=1, end_time=1.8, width=48, height=48,
                                center_crop=True, x_offset=0.5, y_offset=-0.4),
    "longest_to_width": dict(clip_duration=1, start_time=0.2, width=64, height=64,
                             center_crop=True, longest_to_width=True),
    "use_full_clip": dict(use_full_clip=True, width=40, height=32, n_frames=16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_crop_and_resize_matches_jax(clip, case):
    root, path = clip
    got = video_prep.crop_and_resize_video(path, str(root / f"port_{case}"), **CASES[case])
    want = jprep.crop_and_resize_video(path, str(root / f"jax_{case}"), **CASES[case])
    assert os.path.basename(got) == os.path.basename(want) == "clip.mp4"
    got_frames, got_fps = video_prep._read_video(got)
    want_frames, want_fps = jprep._read_video(want)
    assert got_fps == want_fps and len(got_frames) > 1
    kw = CASES[case]
    if not kw.get("longest_to_width"):   # that one fits the frame inside the box
        assert got_frames.shape[1:3] == (kw["height"], kw["width"])
    np.testing.assert_array_equal(got_frames, want_frames)


def test_read_and_extract_frames_match_jax(clip):
    _, path = clip
    frames, fps = video_prep._read_video(path)
    want, want_fps = jprep._read_video(path)
    assert fps == want_fps == FPS and frames.shape == (N, H, W, 3)
    np.testing.assert_array_equal(frames, want)
    for count in (16, 5):
        got = video_prep.extract_frames(path, count)
        ref = jprep.extract_frames(path, count)
        assert len(got) == len(ref) == count
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_read_video_refuses_an_empty_file(tmp_path):
    bad = tmp_path / "empty.mp4"
    bad.write_bytes(b"")
    with pytest.raises(IOError, match="no frames"):
        video_prep._read_video(str(bad))


def test_prepare_video_cli(clip, tmp_path):
    """The CLI on one file and on a folder, with the reference's arguments."""
    _, path = clip
    out = tmp_path / "one"
    prepare_video.main(["--video_path", path, "--output_folder", str(out), "--width", "32",
                        "--height", "32", "--start_time", "0", "--clip_duration", "1",
                        "--center_crop", "--n_frames", "8"])
    frames, fps = video_prep._read_video(str(out / "clip.mp4"))
    assert frames.shape[1:] == (32, 32, 3) and fps == 8 and len(frames) == 8
    folder = tmp_path / "folder"
    prepare_video.main(["--input_folder", os.path.dirname(path), "--output_folder",
                        str(folder), "--width", "24", "--height", "16", "--end_time", "2",
                        "--clip_duration", "1"])
    assert os.listdir(folder) == ["clip.mp4"]
    assert video_prep._read_video(str(folder / "clip.mp4"))[0].shape[1:] == (16, 24, 3)


@pytest.mark.parametrize("motion", sorted(jcamera.CAMERA_MOTIONS))
def test_camera_motions_match_jax(motion):
    rng = np.random.RandomState(3)
    image = Image.fromarray(rng.randint(0, 256, size=(72, 120, 3)).astype(np.uint8))
    got = camera.CAMERA_MOTIONS[motion](image, num_frames=6, crop_width=48)
    want = jcamera.CAMERA_MOTIONS[motion](image, num_frames=6, crop_width=48)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.size == w.size
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
