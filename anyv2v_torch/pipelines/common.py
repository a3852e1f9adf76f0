"""Shared pipeline plumbing (counterpart of ``anyv2v_tpu/pipelines/common.py``,
the parts the single-GPU pipelines use): the VAE latent codec, text encoding,
:func:`group_constant_runs`, and the host-resident inversion trajectory
(:class:`HostTrajectory`, :func:`resolve_chunk_steps`,
:func:`device_rows_for_scan`) of the long-video route."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.vae import mode_from_moments

DEFAULT_CHUNK_STEPS = 25


class HostTrajectory:
    """An inversion trajectory ``[n, B, F, h, w, C]`` held in host memory as
    fp32 tensors, one per inversion chunk, in ascending-t order.

    The reference caches every step on disk (``ddim_latents_{t}.npy``) and
    reloads single rows while editing; this is that cache without the disk.
    The inversion appends each chunk once (one device -> host copy per
    chunk); the edit moves to the device only the rows its injection steps
    read (:meth:`gather_rows`). A 128-frame 500-step fp32 grid is 4.2 GB at
    512^2; a 50-step edit reads at most 50 of its rows.

    Stands in for a device trajectory: ``store[i]`` is a device row,
    ``np.asarray(store)`` the whole grid on the host (the cache writer)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._chunks: list[torch.Tensor] = []

    @classmethod
    def from_array(cls, traj, device) -> "HostTrajectory":
        """A one-chunk store over a host array ``[n, ...]`` (a cache read
        back from disk), without copying fp32 data."""
        store = cls(device)
        store._chunks.append(torch.from_numpy(np.asarray(traj, np.float32)))
        return store

    def append(self, chunk: torch.Tensor) -> None:
        """Store a ``[k, ...]`` chunk on the host as fp32. The copy waits for
        the device once, at the end of the chunk that made it."""
        self._chunks.append(chunk.detach().to("cpu", torch.float32))

    def __len__(self) -> int:
        return sum(c.shape[0] for c in self._chunks)

    @property
    def shape(self):
        return (len(self),) + tuple(self._chunks[0].shape[1:])

    @property
    def nbytes(self) -> int:
        return sum(c.numel() * c.element_size() for c in self._chunks)

    def _rows(self, rows) -> torch.Tensor:
        """Gather rows across chunks without building the whole grid."""
        rows = np.asarray(rows, np.int64)
        out = torch.empty((len(rows),) + tuple(self.shape[1:]), dtype=torch.float32)
        starts = np.cumsum([0] + [c.shape[0] for c in self._chunks])
        ci = np.searchsorted(starts, rows, side="right") - 1
        for j, (r, c) in enumerate(zip(rows, ci)):
            out[j] = self._chunks[c][r - starts[c]]
        return out

    def __array__(self, dtype=None, copy=None):
        grid = (self._chunks[0] if len(self._chunks) == 1
                else torch.cat(self._chunks, dim=0)).numpy()
        return grid if dtype is None else grid.astype(dtype)

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            n = len(self)
            i = int(i)
            if not -n <= i < n:   # wrap negatives only: out of range raises
                raise IndexError(f"row {i} out of range for {n}-row store")
            return self._rows([i % n])[0].to(self.device)
        raise TypeError("HostTrajectory supports integer row indexing and "
                        "gather_rows; use np.asarray() for the full grid")

    def gather_rows(self, rows) -> torch.Tensor:
        """``[len(rows), ...]`` device tensor of the selected rows."""
        return self._rows(rows).to(self.device)


def resolve_chunk_steps(requested: int | None = None) -> int:
    """Steps per inversion chunk (one device -> host copy each with
    ``traj_store="host"``). An explicit ``requested`` value (pipeline
    argument, CLI ``chunk_steps``) wins; ``ANYV2V_SCAN_CHUNK`` fills in only
    when the caller passed None; the default is 25."""
    if requested is not None:
        return max(1, int(requested))
    env = os.environ.get("ANYV2V_SCAN_CHUNK", "").strip()
    if not env:
        return DEFAULT_CHUNK_STEPS
    try:
        return max(1, int(env))
    except ValueError as e:
        raise ValueError(f"ANYV2V_SCAN_CHUNK must be an integer, got {env!r}") from e


def device_rows_for_scan(traj, cache_idx, k: int):
    """Resolve a trajectory for an injection loop of ``k`` steps: a
    :class:`HostTrajectory` becomes a device tensor of only the rows
    ``cache_idx[:k]`` reads, with the indices remapped into it (``None`` for
    ``k == 0``: the loop reads no row); a device trajectory passes through."""
    cache_idx = np.asarray(cache_idx, np.int64)
    if not isinstance(traj, HostTrajectory):
        return traj, cache_idx
    if k == 0:
        return None, cache_idx
    need = np.unique(cache_idx[:k])
    return traj.gather_rows(need), np.searchsorted(need, cache_idx)


def host_array(traj) -> np.ndarray:
    """The whole trajectory as a host array: a device tensor is copied, a
    :class:`HostTrajectory` joins its chunks (no device copy either way)."""
    return traj.cpu().numpy() if torch.is_tensor(traj) else np.asarray(traj)


def run_inversion(step, keep, row_shape, device, traj_store: str = "device",
                  chunk_steps=None):
    """The inversion loop's trajectory bookkeeping, shared by the backbones:
    ``step(i)`` runs inversion step ``i`` and returns its fp32 row
    ``row_shape``; the rows with ``keep[i]`` are kept, in step order. Returns
    a device tensor ``[n_kept, *row_shape]`` (``"device"``) or a
    :class:`HostTrajectory` that receives one copy per chunk of
    ``chunk_steps`` steps (``"host"``: the device holds one chunk at a
    time)."""
    if traj_store not in ("device", "host"):
        raise ValueError(f"traj_store must be 'device' or 'host', got {traj_store!r}")
    keep = np.asarray(keep, bool)

    def rows(n):
        return torch.empty((n,) + tuple(row_shape), dtype=torch.float32, device=device)

    host = traj_store == "host"
    store = HostTrajectory(device) if host else None
    traj = None if host else rows(int(keep.sum()))
    row = 0
    span = min(resolve_chunk_steps(chunk_steps), len(keep))
    for start in range(0, len(keep), span):
        stop = min(start + span, len(keep))
        buf, j = (rows(int(keep[start:stop].sum())), 0) if host else (traj, row)
        for i in range(start, stop):
            x = step(i)
            if keep[i]:
                buf[j] = x
                j += 1
        if host:
            store.append(buf)
        else:
            row = j
    return store if host else traj


def group_constant_runs(masks, k: int):
    """Group steps [0, k) into maximal runs of a constant per-step flag
    pattern. ``masks``: tuple of boolean arrays (one per flag). Returns
    ``[(start, pattern_tuple, stop), ...]`` with Python-bool patterns."""
    runs = []
    for i in range(k):
        pat = tuple(bool(m[i]) for m in masks)
        if runs and runs[-1][1] == pat:
            runs[-1] = (runs[-1][0], pat, i + 1)
        else:
            runs.append((i, pat, i + 1))
    return runs


class LatentCodecMixin:
    """Expects ``vae``, ``text_encoder`` and ``device`` attributes."""

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @torch.inference_mode()
    def _encode_frames(self, frames01) -> torch.Tensor:
        """``[N, H, W, 3]`` in [0, 1] -> scaled latents ``[N, h, w, 4]`` (mode), fp32."""
        x = self._tensor(frames01) * 2.0 - 1.0
        z = mode_from_moments(self.vae.encode_moments(x))
        return z.float() * self.vae.config.scaling_factor

    def encode_video(self, frames01, chunk_size: int = 16) -> torch.Tensor:
        """``[F, H, W, 3]`` -> ``[1, F, h, w, 4]``, in chunks of frames to bound
        activation memory."""
        n = frames01.shape[0]
        outs = [self._encode_frames(frames01[i:i + chunk_size]) for i in range(0, n, chunk_size)]
        return torch.cat(outs, dim=0)[None]

    @torch.inference_mode()
    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        img = self.vae.decode(latents / self.vae.config.scaling_factor)
        return torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)

    def decode_latents(self, latents, chunk_size: int = 16) -> torch.Tensor:
        """``[1, F, h, w, 4]`` -> video ``[F, H, W, 3]`` in [0, 1], fp32."""
        z = self._tensor(latents)[0]
        return torch.cat([self._decode(z[i:i + chunk_size])
                          for i in range(0, z.shape[0], chunk_size)], dim=0)

    @torch.inference_mode()
    def encode_text(self, input_ids) -> torch.Tensor:
        hidden, _ = self.text_encoder(torch.as_tensor(input_ids, dtype=torch.long,
                                                      device=self.device))
        return hidden
