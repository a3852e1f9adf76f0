"""Video preparation: trim, scale, centre-crop with offsets, even-time frame
extraction (counterpart of ``anyv2v_tpu/utils/video_prep.py``).

The reference's moviepy helpers rebuilt with OpenCV:
``black_box_image_edit/utils.py:7-84`` (crop_and_resize_video) and
``prepare_video.py:9-24`` (extract_frames). OpenCV and PIL are imported
inside the functions, so the module loads where they are absent.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

import numpy as np


def _read_video(path: str):
    """Returns (frames uint8 RGB [N, H, W, 3], fps)."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames), float(fps)


def extract_frames(video_path: str, frame_count: int = 16) -> List:
    """Evenly spaced frames over the clip's duration, as PIL images
    (reference ``prepare_video.py:9-24``)."""
    from PIL import Image

    frames, _ = _read_video(video_path)
    idx = np.linspace(0, len(frames), frame_count, endpoint=False).astype(int)
    return [Image.fromarray(frames[i]) for i in idx]


def crop_and_resize_video(
    input_video_path: str,
    output_folder: str,
    clip_duration: Optional[float] = None,
    width: Optional[int] = None,
    height: Optional[int] = None,
    start_time: Optional[float] = None,
    end_time: Optional[float] = None,
    n_frames: int = 16,
    center_crop: bool = False,
    x_offset: float = 0.0,
    y_offset: float = 0.0,
    longest_to_width: bool = False,
    use_full_clip: bool = False,
) -> Optional[str]:
    """Reference ``black_box_image_edit/utils.py:7-84`` semantics:

    - temporal crop: [start, start+duration] / [end-duration, end] / random;
    - optional scale + centre crop with offsets in [-1, 1];
    - output fps = n_frames // clip_duration; writes <output>/<basename>.
    """
    import cv2

    from .io import save_video

    frames, fps = _read_video(input_video_path)
    duration = len(frames) / fps

    if use_full_clip:
        sel = frames
        clip_duration = clip_duration or duration
    else:
        if clip_duration is None and start_time is not None and end_time is not None:
            start_time, end_time = float(start_time), float(end_time)
            clip_duration = int(end_time - start_time)
        elif clip_duration is not None:
            if start_time is not None:
                start_time = float(start_time)
                end_time = start_time + clip_duration
            elif end_time is not None:
                end_time = float(end_time)
                start_time = end_time - clip_duration
            else:
                if duration <= clip_duration:
                    print(f"Skipping {input_video_path}: duration <= clip duration.")
                    return None
                start_time = random.uniform(0, duration - clip_duration)
                end_time = start_time + clip_duration
        else:
            raise ValueError("provide clip_duration or both start_time and end_time")
        i0, i1 = int(start_time * fps), int(end_time * fps)
        sel = frames[i0:max(i1, i0 + 1)]

    if center_crop and width and height:
        vh, vw = sel.shape[1:3]
        scale_w, scale_h = vw / width, vh / height
        scale = max(scale_w, scale_h) if longest_to_width else min(scale_w, scale_h)
        new_w, new_h = int(vw / scale), int(vh / scale)
        sel = np.stack([cv2.resize(f, (new_w, new_h)) for f in sel])
        off_x = int(((x_offset + 1) / 2) * (new_w - width))
        off_y = int(((y_offset + 1) / 2) * (new_h - height))
        off_x = max(0, min(new_w - width, off_x))
        off_y = max(0, min(new_h - height, off_y))
        sel = sel[:, off_y:off_y + height, off_x:off_x + width]
    elif width and height:
        sel = np.stack([cv2.resize(f, (width, height)) for f in sel])

    out_fps = max(1, int(n_frames // max(clip_duration, 1e-9)))
    # resample to n_frames at the output fps (moviepy's set_fps)
    idx = np.linspace(0, len(sel) - 1, min(len(sel), int(out_fps * clip_duration))
                      ).round().astype(int)
    sel = sel[idx]

    os.makedirs(output_folder, exist_ok=True)
    out_path = os.path.join(output_folder, os.path.basename(input_video_path))
    save_video(sel.astype(np.float32) / 255.0, out_path, fps=out_fps)
    print(f"Processed {input_video_path}, saved to {out_path}")
    return out_path
