"""Frame-sharded multi-GPU on ``torch.distributed`` (counterpart of
``anyv2v_tpu/parallel/mesh.py``).

Two mesh axes, as the JAX package's:

- "frame": video frames. Spatial UNet layers and the VAE fold frames into
  the batch, so they run on each rank's frames alone; the frame-coupled ops
  (temporal attention, the (3,1,1) temporal conv and its groupnorm) talk
  across ranks with the collectives below.
- "cfg": the CFG rows of a batch, pure data parallelism.

Every rank runs the same Python program (SPMD, one process per GPU, started
by ``torchrun`` or by hand). Parameters are replicated: inference keeps no
optimizer state, and one UNet fits one card.

The UNet forward runs as a manual-SPMD region: :func:`manual_axis` marks it,
and inside it the frame-coupled ops switch to their sharded branches
(all-to-all frames <-> pixels around the op, or a gather of the frame axis
where the pixel count does not divide). :func:`mock_manual_axis` runs the
same per-rank program on one device, every collective replaced by a local
op of the same shape: its outputs mean nothing, and it exists to run the
sharded kernels at their per-rank shapes on one card.

The collectives are inference-only (no autograd). On CUDA tensors they run
on NCCL, on CPU tensors on gloo.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.distributed as dist


def make_mesh(n_cfg: int = 1, n_frame: Optional[int] = None, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of shape ``(n_cfg, n_frame)`` with dims ``("cfg",
    "frame")`` over the initialised default process group (``n_frame``
    defaults to the world size over ``n_cfg``). ``device_type`` "cuda" (the
    default) needs the NCCL backend, "cpu" gloo. Raises without a process
    group: there is no single-device mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torchrun, or torch.distributed.init_process_group)")
    device_type = device_type or "cuda"
    backend = str(dist.get_backend())
    need = {"cuda": "nccl", "cpu": "gloo"}.get(device_type)
    if need is None or need not in backend:
        raise ValueError(f"a {device_type} mesh needs the {need or 'nccl or gloo'} backend, "
                         f"the process group has {backend}")
    world = dist.get_world_size()
    if n_frame is None:
        n_frame = world // n_cfg
    if n_cfg * n_frame != world:
        raise ValueError(f"{n_cfg}x{n_frame} mesh != {world} ranks")
    return init_device_mesh(device_type, (n_cfg, n_frame), mesh_dim_names=("cfg", "frame"))


def axis_size(mesh, name: str) -> int:
    """The number of ranks along mesh dim ``name`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(name))


def _window(x: torch.Tensor, n: int, i: int, axis: int) -> torch.Tensor:
    size = x.shape[axis] // n
    return x.narrow(axis, i * size, size).contiguous()


def video_sharding(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of ``[B, F, H, W, C]``: its frame window over
    "frame" (:func:`local_frame_slice`, the window the pipelines' step loops
    carry), and its CFG rows over "cfg" where the rows divide."""
    n_cfg, n_frame = axis_size(mesh, "cfg"), axis_size(mesh, "frame")
    if n_cfg > 1 and x.shape[0] % n_cfg == 0:
        x = _window(x, n_cfg, mesh.get_local_rank("cfg"), 0)
    if n_frame <= 1:
        return x
    return local_frame_slice(x, mesh.get_group("frame"), x.shape[1] // n_frame)


def frames_sharding(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's share of a flat frame batch ``[N, ...]`` over every rank
    of the mesh (both axes): ``ceil(N / ranks)`` frames, the batch padded
    with copies of its last frame so that every share is full."""
    world = mesh.size()
    share = -(-x.shape[0] // world)
    pad = share * world - x.shape[0]
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)
    return x.narrow(0, _mesh_rank(mesh) * share, share).contiguous()


def gather_frame_shares(x: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """Inverse of :func:`frames_sharding`: every rank's share gathered in
    rank order, trimmed to the ``n`` frames of the batch."""
    out = x.new_empty((x.shape[0] * mesh.size(),) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=_world_group(mesh))
    return out[:n]


def replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """The same copy on every rank: the mesh's first rank's ``x`` (a new
    tensor; ``x`` is left as it is)."""
    x = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(x, src=int(mesh.mesh.flatten()[0]), group=_world_group(mesh))
    return x


def shard_params(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Replicate ``module``'s parameters and buffers: every rank gets the
    mesh's first rank's values (ranks that built the same weights from the
    same seed get them unchanged)."""
    src, group = int(mesh.mesh.flatten()[0]), _world_group(mesh)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return module


def _mesh_rank(mesh) -> int:
    return mesh.get_local_rank("cfg") * axis_size(mesh, "frame") + mesh.get_local_rank("frame")


def _world_group(mesh):
    """The process group of every rank of the mesh (its two dims' ranks
    together): the default group when the mesh spans the world."""
    if mesh.size() == dist.get_world_size():
        return None
    raise ValueError("a mesh over part of the world is not supported")


# ---------------------------------------------------------------------------
# the manual-SPMD region of the video UNet
# ---------------------------------------------------------------------------

_MANUAL_AXIS = threading.local()


@contextlib.contextmanager
def _region(group, size: int, mock: bool):
    prev = getattr(_MANUAL_AXIS, "value", None), getattr(_MANUAL_AXIS, "mock", False)
    _MANUAL_AXIS.value, _MANUAL_AXIS.mock = (group, size), mock
    try:
        yield
    finally:
        _MANUAL_AXIS.value, _MANUAL_AXIS.mock = prev


def manual_axis(group, size: int):
    """Mark the extent of a UNet forward whose frames are sharded over the
    process group ``group`` of ``size`` ranks: the frame-coupled ops read it
    and take their sharded branches."""
    return _region(group, size, mock=False)


def mock_manual_axis(size: int):
    """The per-rank program of a ``size``-rank region on one device: each
    collective becomes a local op of the same shape and local traffic
    (all-to-all -> split + concat, all-gather -> tile, all-reduce ->
    identity, the rank -> 0). Feed it the per-rank shapes (F/size frames);
    its outputs mean nothing."""
    return _region(None, size, mock=True)


def current_manual_axis():
    """``(group, size)`` inside a manual-SPMD region (``group`` None in a
    mock region), else None."""
    return getattr(_MANUAL_AXIS, "value", None)


def sharded_region():
    """``(group, size)`` inside a manual-SPMD region of more than one rank,
    else None."""
    region = current_manual_axis()
    return region if region is not None and region[1] > 1 else None


def _mock_size():
    if getattr(_MANUAL_AXIS, "mock", False):
        return _MANUAL_AXIS.value[1]
    return None


def frames_to_pixels(x: torch.Tensor, group, frame_axis: int, pixel_axis: int) -> torch.Tensor:
    """``[.., F/n (frame_axis), .., P (pixel_axis), ..]`` -> ``[.., F, .., P/n, ..]``
    by a tiled all-to-all: rank i keeps the pixels ``[i P/n, (i+1) P/n)`` of
    every rank's frames, frames in rank order (``jax.lax.all_to_all(...,
    tiled=True)``'s split)."""
    n = _mock_size()
    if n is not None:
        return torch.cat(torch.chunk(x, n, dim=pixel_axis), dim=frame_axis)
    n = dist.get_world_size(group)
    y = x.movedim((pixel_axis, frame_axis), (0, 1))          # [P, F/n, ...]
    p, f = y.shape[:2]
    send = y.reshape(n, p // n, *y.shape[1:]).contiguous()
    recv = torch.empty_like(send)                           # [n (source), P/n, F/n, ...]
    dist.all_to_all_single(recv, send, group=group)
    out = recv.transpose(0, 1).reshape(p // n, n * f, *y.shape[2:])
    return out.movedim((0, 1), (pixel_axis, frame_axis)).contiguous()


def pixels_to_frames(x: torch.Tensor, group, frame_axis: int, pixel_axis: int) -> torch.Tensor:
    """Inverse of :func:`frames_to_pixels`."""
    n = _mock_size()
    if n is not None:
        return torch.cat(torch.chunk(x, n, dim=frame_axis), dim=pixel_axis)
    n = dist.get_world_size(group)
    y = x.movedim((frame_axis, pixel_axis), (0, 1))          # [F, P/n, ...]
    f, p = y.shape[:2]
    send = y.reshape(n, f // n, *y.shape[1:]).contiguous()
    recv = torch.empty_like(send)                           # [n (source), F/n, P/n, ...]
    dist.all_to_all_single(recv, send, group=group)
    out = recv.transpose(0, 1).reshape(f // n, n * p, *y.shape[2:])
    return out.movedim((0, 1), (frame_axis, pixel_axis)).contiguous()


def all_gather_axis(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``axis``, in rank
    order (n copies of ``x`` in a mock region)."""
    n = _mock_size()
    if n is not None:
        return torch.cat([x] * n, dim=axis)
    y = x.movedim(axis, 0).contiguous()
    out = y.new_empty((y.shape[0] * dist.get_world_size(group),) + tuple(y.shape[1:]))
    dist.all_gather_into_tensor(out, y, group=group)
    return out.movedim(0, axis).contiguous()


def gather_frames(x: torch.Tensor, group, frame_axis: int) -> torch.Tensor:
    """All-gather the frame axis, in rank order (the deep levels whose pixel
    count does not divide the ranks: their tensors are small)."""
    return all_gather_axis(x, group, frame_axis)


def gather_pixels(x: torch.Tensor, group, pixel_axis: int) -> torch.Tensor:
    """All-gather the pixel axis: re-replicates a frame that rides every
    rank (ConsistI2V's conditioning frame) after a pixel-sharded op."""
    return all_gather_axis(x, group, pixel_axis)


def axis_index(group) -> int:
    """This rank's index in ``group`` (0 in a mock region)."""
    return 0 if _mock_size() is not None else dist.get_rank(group)


def pmean_axis(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (the identity in a mock
    region). The ranks' values are gathered and summed in rank order, then
    divided by their count: every rank gets the same bits, on any backend,
    and those of ``jax.lax.pmean`` (which sums in device order). Its callers
    average per-group moments, a few hundred numbers."""
    n = _mock_size()
    if n is not None:
        return x
    parts = all_gather_axis(x[None], group, 0)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total / parts.shape[0]


def local_pixel_slice(x: torch.Tensor, group, n: int, pixel_axis: int) -> torch.Tensor:
    """This rank's pixels of a replicated tensor, the window that
    :func:`frames_to_pixels` gives it."""
    return _window(x, n, axis_index(group), pixel_axis)


def local_frame_slice(x: torch.Tensor, group, f_loc: int, frame_axis: int = 1) -> torch.Tensor:
    """This rank's ``f_loc`` frames of a tensor holding every rank's frames."""
    return _window(x, x.shape[frame_axis] // f_loc, axis_index(group), frame_axis)


# ---------------------------------------------------------------------------
# the resharding policy of the frame-coupled ops
# ---------------------------------------------------------------------------

MIN_PIXEL_SHARE = 8


def around_frame_op(fn, tensors, f0row: int = 0, gather: bool = True):
    """``fn(*tensors, mode)`` for a frame-coupled op (temporal attention, the
    temporal conv) on this rank's ``[B, f0row + F/n, P, C]`` tensors, run so
    that it sees every frame: the one resharding policy of the sharded UNets.

    Outside a manual-SPMD region of n > 1 ranks ``mode`` is None and the
    tensors pass as they are. Inside, where the pixels divide into shares of
    at least :data:`MIN_PIXEL_SHARE`, an all-to-all to pixel sharding (``mode``
    "pixels", ``[B, f0row + F, P/n, C]``), ``fn``, and back; elsewhere a
    gather of the frame axis (``mode`` "frames", ``[B, f0row + F, P, C]``),
    ``fn``, and this rank's frames kept. ``gather=False`` leaves that second
    case to ``fn``'s own ops (``mode`` None): a module that hoists the
    all-to-all to its boundary. ``f0row`` leading rows that every rank holds
    whole (ConsistI2V's conditioning frame) stay out of the all-to-all: in
    pixel mode ``fn`` gets this rank's pixels of them and their output rows
    are gathered whole again. The result has the first tensor's frames."""
    region = sharded_region()
    if region is None:
        return fn(*tensors, None)
    group, n = region
    p, f_loc = tensors[0].shape[2], tensors[0].shape[1] - f0row
    if p % n == 0 and p // n >= MIN_PIXEL_SHARE:
        ins = [frames_to_pixels(t[:, f0row:], group, 1, 2) for t in tensors]
        if f0row:
            ins = [torch.cat([local_pixel_slice(t[:, :f0row], group, n, 2), x], dim=1)
                   for t, x in zip(tensors, ins)]
        out = fn(*ins, "pixels")
        real = pixels_to_frames(out[:, f0row:], group, 1, 2)
        return torch.cat([gather_pixels(out[:, :f0row], group, 2), real], dim=1) if f0row else real
    if not gather:
        return fn(*tensors, None)
    ins = [gather_frames(t[:, f0row:], group, 1) for t in tensors]
    if f0row:
        ins = [torch.cat([t[:, :f0row], x], dim=1) for t, x in zip(tensors, ins)]
    out = fn(*ins, "frames")
    real = local_frame_slice(out[:, f0row:], group, f_loc)
    return torch.cat([out[:, :f0row], real], dim=1) if f0row else real
