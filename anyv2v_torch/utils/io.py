"""Host-side IO (the port's own copy of ``anyv2v_tpu/utils/io.py``).

- The two-phase latent cache with numpy alone: ``ddim_trajectory.npz``,
  ``meta.json`` and one ``ddim_latents_{t}.npy`` per inversion timestep,
  latents channels-last ``[1, F, h, w, C]`` fp32 (the same files as the JAX
  package writes).
- Frames, videos and image preprocessing for the CLI shells. PIL, OpenCV and
  imageio are imported inside these functions only, so the module (and every
  per-entry function) loads where they are absent.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

_LATENT_RE = re.compile(r"ddim_latents_(\d+)\.npy$")


# ---------------------------------------------------------------------------
# image preprocessing (reference pipeline_i2vgen_xl.py:1473-1509)
# ---------------------------------------------------------------------------


def center_crop_wide(img, size: Tuple[int, int]):
    """Reference ``_center_crop_wide`` (:1487): scale so the short relative
    side matches, then center-crop a PIL image to (width, height)."""
    from PIL import Image

    w, h = size
    scale = max(w / img.width, h / img.height)
    img = img.resize((round(img.width * scale), round(img.height * scale)), Image.BOX)
    x0 = (img.width - w) // 2
    y0 = (img.height - h) // 2
    return img.crop((x0, y0, x0 + w, y0 + h))


def resize_bilinear(img, size: Tuple[int, int]):
    """A PIL image resized to (width, height), bilinear."""
    from PIL import Image

    return img.resize(size, Image.BILINEAR)


def image_to_array01(img) -> np.ndarray:
    return np.asarray(img.convert("RGB"), np.float32) / 255.0


# ---------------------------------------------------------------------------
# frames / video
# ---------------------------------------------------------------------------


def convert_video_to_frames(video_path: str, out_dir: str, size: Tuple[int, int]) -> List[str]:
    """mp4 -> %05d.png with LANCZOS resize (reference ``utils.py:43-66``),
    decoded with OpenCV."""
    import cv2
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    cap = cv2.VideoCapture(video_path)
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        img = Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        img = img.resize(size, Image.LANCZOS)
        p = os.path.join(out_dir, f"{i:05d}.png")
        img.save(p)
        paths.append(p)
        i += 1
    cap.release()
    return paths


def load_video_frames(frames_dir: str, n_frames: int, size: Optional[Tuple[int, int]] = None) -> list:
    """Strict %05d.png loader (reference ``utils.py:70-79``): PIL images."""
    from PIL import Image

    frames = []
    for i in range(n_frames):
        p = os.path.join(frames_dir, f"{i:05d}.png")
        if not os.path.exists(p):
            raise FileNotFoundError(f"expected frame {p}")
        img = Image.open(p).convert("RGB")
        if size is not None and img.size != size:
            img = img.resize(size, Image.LANCZOS)
        frames.append(img)
    return frames


def frames_to_array01(frames: Sequence) -> np.ndarray:
    return np.stack([image_to_array01(f) for f in frames])  # [F, H, W, 3]


def save_video(frames01: np.ndarray, path: str, fps: int = 8) -> None:
    """[F, H, W, 3] in [0,1] -> mp4 (OpenCV) or gif (imageio)."""
    frames = (np.clip(frames01, 0, 1) * 255).astype(np.uint8)
    if path.endswith(".gif"):
        import imageio

        imageio.mimsave(path, list(frames), duration=1000 / fps, loop=0)
        return
    import cv2

    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {path}")
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def save_frames(frames01: np.ndarray, out_dir: str) -> None:
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate((np.clip(frames01, 0, 1) * 255).astype(np.uint8)):
        Image.fromarray(f).save(os.path.join(out_dir, f"{i:05d}.png"))


# ---------------------------------------------------------------------------
# latent cache (two-phase CLI bus)
# ---------------------------------------------------------------------------


def save_ddim_trajectory(out_dir: str, trajectory: np.ndarray, timesteps: np.ndarray) -> None:
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "ddim_trajectory.npz"),
             trajectory=trajectory.astype(np.float32),
             timesteps=np.asarray(timesteps, np.int64))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"layout": "BFHWC", "n_steps": int(len(timesteps))}, f)
    for i, t in enumerate(timesteps):
        np.save(os.path.join(out_dir, f"ddim_latents_{int(t)}.npy"), trajectory[i])


def load_ddim_trajectory(cache_dir: str, per_step_files: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (trajectory ``[n, 1, F, h, w, C]``, ascending timesteps ``[n]``),
    from the consolidated file, or from the ``ddim_latents_{t}.npy`` files
    when there is none or ``per_step_files`` is set."""
    consolidated = os.path.join(cache_dir, "ddim_trajectory.npz")
    if os.path.exists(consolidated) and not per_step_files:
        data = np.load(consolidated)
        return data["trajectory"], data["timesteps"]
    entries = sorted((int(m.group(1)), name) for name in os.listdir(cache_dir)
                     if (m := _LATENT_RE.search(name)))
    if not entries:
        raise FileNotFoundError(f"no ddim latents found in {cache_dir}")
    ts = np.array([t for t, _ in entries], np.int64)
    traj = np.stack([np.load(os.path.join(cache_dir, n)) for _, n in entries])
    return traj, ts


def load_ddim_latents_at_t(t: int, cache_dir: str) -> np.ndarray:
    """One cached latent, ``ddim_latents_{t}.npy`` (the reference's
    ``load_ddim_latents_at_t``, ``i2vgen-xl/utils.py:25-30``)."""
    p = os.path.join(cache_dir, f"ddim_latents_{int(t)}.npy")
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return np.load(p)
