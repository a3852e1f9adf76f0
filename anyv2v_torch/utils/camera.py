"""Camera-motion synthesis: a video from a still image by animated crops
(counterpart of ``anyv2v_tpu/utils/camera.py``; reference
``pipeline_video_editing.py:63-118`` pan_right / pan_left / zoom_in /
zoom_out, torchvision crops there, PIL here). PIL is imported inside the
functions, so the module loads where it is absent."""

from __future__ import annotations

from typing import List


def _crop(img, top: int, left: int, height: int, width: int):
    return img.crop((left, top, left + width, top + height))


def pan_right(image, num_frames: int = 16, crop_width: int = 256) -> List:
    w, h = image.size
    return [
        _crop(image, 0, int((w - crop_width) * (i / num_frames)), h, crop_width)
        for i in range(num_frames)
    ]


def pan_left(image, num_frames: int = 16, crop_width: int = 256) -> List:
    w, h = image.size
    return [
        _crop(image, 0, int((w - crop_width) * (1 - i / num_frames)), h, crop_width)
        for i in range(num_frames)
    ]


def zoom_in(image, num_frames: int = 16, crop_width: int = 256, ratio: float = 1.5) -> List:
    from PIL import Image

    w, h = image.size
    max_crop = min(w, h)
    frames = []
    for i in range(num_frames):
        size = max_crop - int((max_crop - max_crop // ratio) * (i / num_frames))
        left, top = (w - size) // 2, (h - size) // 2
        frames.append(_crop(image, top, left, size, size).resize(
            (crop_width, crop_width), Image.BILINEAR))
    return frames


def zoom_out(image, num_frames: int = 16, crop_width: int = 256, ratio: float = 1.5) -> List:
    from PIL import Image

    w, h = image.size
    min_crop = int(min(w, h) // ratio)
    frames = []
    for i in range(num_frames):
        size = min_crop + int((min(w, h) - min_crop) * (i / num_frames))
        left, top = (w - size) // 2, (h - size) // 2
        frames.append(_crop(image, top, left, size, size).resize(
            (crop_width, crop_width), Image.BILINEAR))
    return frames


CAMERA_MOTIONS = {
    "pan_right": pan_right,
    "pan_left": pan_left,
    "zoom_in": zoom_in,
    "zoom_out": zoom_out,
}
