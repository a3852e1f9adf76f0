"""Shared pipeline plumbing (counterpart of ``anyv2v_tpu/pipelines/common.py``):
the VAE latent codec, text encoding, :func:`group_constant_runs`, the
host-resident inversion trajectory (:class:`HostTrajectory`,
:func:`resolve_chunk_steps`, :func:`device_rows_for_scan`) of the long-video
route, and the frame sharding over a mesh (:class:`ShardingMixin`).

Sharding, when a pipeline has a ``mesh`` (:func:`anyv2v_torch.parallel.
mesh.make_mesh`): every rank runs the same call with the same arguments
(the whole clip's tensors), and gets the same result (the whole clip's).
Inside, the frames split over the mesh's "frame" ranks:

- the step loop carries this rank's frame window of the latent; the UNet
  forward runs in a manual-SPMD region and sees only those frames (the
  image conditioning of i2vgen-xl and ConsistI2V's first frame ride every
  rank whole); the scheduler step is per frame;
- each inversion step's latent is gathered once over the frame ranks, so
  the trajectory (a device tensor or a :class:`HostTrajectory`) holds the
  whole clip on every rank, and the edit reads its window of each row;
- the VAE encodes and decodes each rank's share of the frames (over both
  mesh axes) and gathers the results;
- a mesh with a "cfg" axis of more than one rank runs the plain program on
  every rank, its CFG rows split over "cfg" where no PnP injection couples
  them (i2vgen-xl's plain CFG sampling), as the JAX package gates it."""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from ..models.vae import mode_from_moments
from ..parallel.mesh import (all_gather_axis, axis_size, frames_sharding, gather_frame_shares,
                             gather_frames, local_frame_slice, manual_axis, shard_params)
from ..utils.profiling import spanned

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

    @spanned("traj.to_host")
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

    @spanned("traj.to_device")
    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            n = len(self)
            i = int(i)
            if not -n <= i < n:   # wrap negatives only: out of range raises
                raise IndexError(f"row {i} out of range for {n}-row store")
            return self._rows([i % n])[0].to(self.device)
        raise TypeError("HostTrajectory supports integer row indexing and "
                        "gather_rows; use np.asarray() for the full grid")

    @spanned("traj.to_device")
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


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """How one pipeline call splits its frames: over the ``n`` ranks of the
    process group ``group``, or not (n = 1)."""

    group: object = None
    n: int = 1

    def local(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """This rank's frame window of the whole clip's ``x``."""
        return x if self.n == 1 else local_frame_slice(x, self.group, x.shape[axis] // self.n,
                                                        axis)

    def gather(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """The whole clip from every rank's window."""
        return x if self.n == 1 else gather_frames(x, self.group, axis)

    def region(self):
        """The manual-SPMD region of the UNet forwards."""
        return manual_axis(self.group, self.n) if self.n > 1 else contextlib.nullcontext()


class ShardingMixin:
    """Frame and CFG sharding over the pipeline's ``mesh`` attribute (absent
    or None: one device); see the module docstring."""

    @property
    def _mesh(self):
        return getattr(self, "mesh", None)

    def __post_init__(self):
        """Every module's weights replicated from the mesh's first rank."""
        if self._mesh is not None:
            for f in dataclasses.fields(self):
                m = getattr(self, f.name)
                if isinstance(m, torch.nn.Module):
                    shard_params(m, self._mesh)

    def _frame_plan(self, frames: int) -> FramePlan:
        """The frame split of a call on ``frames`` denoised frames: over the
        mesh's "frame" ranks where they divide the frames and the "cfg" axis
        is one rank, else none (the plain program)."""
        mesh = self._mesh
        n = axis_size(mesh, "frame")
        if n <= 1 or frames % n or axis_size(mesh, "cfg") > 1:
            return FramePlan()
        return FramePlan(mesh.get_group("frame"), n)

    def _cfg_split(self, fn, rows: torch.Tensor, *row_args) -> torch.Tensor:
        """``fn(rows, *row_args)`` with the rows (and each row-aligned
        argument's) split over the mesh's "cfg" ranks and the results
        gathered, where the ranks divide the rows; else ``fn`` whole."""
        n = axis_size(self._mesh, "cfg")
        if n <= 1 or rows.shape[0] % n:
            return fn(rows, *row_args)
        k, c = rows.shape[0] // n, self._mesh.get_local_rank("cfg")
        out = fn(*(a[c * k:(c + 1) * k] for a in (rows, *row_args)))
        return all_gather_axis(out, self._mesh.get_group("cfg"), 0)


class LatentCodecMixin(ShardingMixin):
    """Expects ``vae``, ``text_encoder`` and ``device`` attributes (and
    ``mesh``, where the pipeline shards)."""

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @torch.inference_mode()
    def _encode_frames(self, frames01) -> torch.Tensor:
        """``[N, H, W, 3]`` in [0, 1] -> scaled latents ``[N, h, w, 4]`` (mode), fp32."""
        x = self._tensor(frames01) * 2.0 - 1.0
        z = mode_from_moments(self.vae.encode_moments(x))
        return z.float() * self.vae.config.scaling_factor

    @spanned("pipe.encode")
    def encode_video(self, frames01, chunk_size: int = 16) -> torch.Tensor:
        """``[F, H, W, 3]`` -> ``[1, F, h, w, 4]``, in chunks of frames to bound
        activation memory (with a mesh, each rank's share of the frames)."""
        n = frames01.shape[0]
        if self._mesh is not None:
            frames01 = frames_sharding(self._tensor(frames01), self._mesh)
        outs = [self._encode_frames(frames01[i:i + chunk_size])
                for i in range(0, frames01.shape[0], chunk_size)]
        z = torch.cat(outs, dim=0)
        return (z if self._mesh is None else gather_frame_shares(z, self._mesh, n))[None]

    @torch.inference_mode()
    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        img = self.vae.decode(latents / self.vae.config.scaling_factor)
        return torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)

    @spanned("pipe.decode")
    def decode_latents(self, latents, chunk_size: int = 16) -> torch.Tensor:
        """``[1, F, h, w, 4]`` -> video ``[F, H, W, 3]`` in [0, 1], fp32 (with a
        mesh, each rank decodes its share of the frames)."""
        z = self._tensor(latents)[0]
        n = z.shape[0]
        if self._mesh is not None:
            z = frames_sharding(z, self._mesh)
        video = torch.cat([self._decode(z[i:i + chunk_size])
                           for i in range(0, z.shape[0], chunk_size)], dim=0)
        return video if self._mesh is None else gather_frame_shares(video, self._mesh, n)

    @torch.inference_mode()
    def encode_text(self, input_ids) -> torch.Tensor:
        hidden, _ = self.text_encoder(torch.as_tensor(input_ids, dtype=torch.long,
                                                      device=self.device))
        return hidden
