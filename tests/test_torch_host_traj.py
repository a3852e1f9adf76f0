"""The port's host-resident inversion trajectory against the JAX package's:
``HostTrajectory`` (append, length, shape, bytes, the whole grid, integer
rows with negative wrap and range errors, slices refused, rows gathered
across chunk boundaries), the edit's row gather (``device_rows_for_scan``)
and ``resolve_chunk_steps``'s precedence (an explicit value over
``ANYV2V_SCAN_CHUNK`` over the default 25). Both stores get the same
numpy-seeded fp32 chunks of 3, 2 and 4 rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.pipelines import common as jcommon
from anyv2v_torch.pipelines import common

ROW = (1, 3, 2, 2, 4)


@pytest.fixture()
def stores():
    rng = np.random.RandomState(0)
    chunks = [rng.randn(k, *ROW).astype(np.float32) for k in (3, 2, 4)]
    mine, ref = common.HostTrajectory("cpu"), jcommon.HostTrajectory()
    for c in chunks:
        mine.append(torch.from_numpy(c))
        ref.append(jnp.asarray(c))
    return mine, ref, np.concatenate(chunks)


def test_len_shape_nbytes_and_grid(stores):
    mine, ref, grid = stores
    assert len(mine) == len(ref) == 9
    assert mine.shape == tuple(ref.shape) == (9,) + ROW
    assert mine.nbytes == ref.nbytes == grid.nbytes
    np.testing.assert_array_equal(np.asarray(mine), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(mine), grid)
    assert np.asarray(mine, dtype=np.float64).dtype == np.float64


def test_integer_rows_wrap_negatives_and_raise_out_of_range(stores):
    mine, ref, grid = stores
    for i in list(range(-9, 9)) + [np.int64(4)]:
        row = mine[i]
        assert isinstance(row, torch.Tensor) and row.dtype == torch.float32
        np.testing.assert_array_equal(row.numpy(), np.asarray(ref[i]))
        np.testing.assert_array_equal(row.numpy(), grid[i])
    for i in (9, -10):
        for store in (mine, ref):
            with pytest.raises(IndexError):
                store[i]
    for store in (mine, ref):
        with pytest.raises(TypeError):
            store[1:3]


def test_gather_rows_across_chunks(stores):
    mine, ref, grid = stores
    rows = [8, 0, 2, 3, 4, 5]          # every chunk, both ends of the middle one
    got = mine.gather_rows(rows)
    assert got.shape == (6,) + ROW and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.gather_rows(rows)))
    np.testing.assert_array_equal(got.numpy(), grid[rows])


def test_appended_chunks_are_fp32_host_copies():
    store = common.HostTrajectory("cpu")
    chunk = torch.ones(2, *ROW, dtype=torch.bfloat16)
    store.append(chunk)
    chunk.zero_()
    assert np.asarray(store).dtype == np.float32 and float(np.asarray(store).min()) == 1.0


def test_device_rows_for_scan_matches_jax(stores):
    """The edit's gather: only the rows of the first k steps, indices
    remapped into them; a tensor trajectory passes through; k == 0 reads
    nothing."""
    mine, ref, grid = stores
    idx = np.array([7, 2, 7, 3, 8], np.int32)
    rows, remap = common.device_rows_for_scan(mine, idx, 3)
    jrows, jremap = jcommon.ShardingMixin()._device_rows_for_scan(ref, idx, 3)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(remap, jremap)
    for i in range(3):
        np.testing.assert_array_equal(rows[remap[i]].numpy(), grid[idx[i]])
    assert common.device_rows_for_scan(mine, idx, 0)[0] is None
    dense = torch.from_numpy(grid)
    assert common.device_rows_for_scan(dense, idx, 3)[0] is dense


def test_host_array_and_from_array(stores):
    mine, _, grid = stores
    np.testing.assert_array_equal(common.host_array(mine), grid)
    np.testing.assert_array_equal(common.host_array(torch.from_numpy(grid)), grid)
    again = common.HostTrajectory.from_array(grid, "cpu")
    assert len(again) == 9
    np.testing.assert_array_equal(again.gather_rows([1, 6]).numpy(), grid[[1, 6]])


def test_resolve_chunk_steps_precedence(monkeypatch):
    monkeypatch.delenv("ANYV2V_SCAN_CHUNK", raising=False)
    for fn in (common.resolve_chunk_steps, jcommon.resolve_chunk_steps):
        assert fn() == fn(None) == 25
        assert fn(3) == 3 and fn(0) == 1
    monkeypatch.setenv("ANYV2V_SCAN_CHUNK", "7")
    for fn in (common.resolve_chunk_steps, jcommon.resolve_chunk_steps):
        assert fn(None) == 7
        assert fn(3) == 3            # an explicit value wins over the variable
    monkeypatch.setenv("ANYV2V_SCAN_CHUNK", "seven")
    for fn in (common.resolve_chunk_steps, jcommon.resolve_chunk_steps):
        with pytest.raises(ValueError, match="ANYV2V_SCAN_CHUNK"):
            fn(None)
        assert fn(2) == 2


def test_run_inversion_chunks_and_save_grid(monkeypatch):
    """The shared inversion loop: "host" gives the device result row for
    row, one append per chunk; ``keep`` selects rows in step order."""
    keep = np.array([True, False, True, True, False, True, True])
    rows = [torch.full(ROW, float(i)) for i in range(len(keep))]
    dense = common.run_inversion(lambda i: rows[i], keep, ROW, "cpu")
    appended = []
    orig = common.HostTrajectory.append
    monkeypatch.setattr(common.HostTrajectory, "append",
                        lambda self, chunk: appended.append(chunk.shape[0]) or orig(self, chunk))
    store = common.run_inversion(lambda i: rows[i], keep, ROW, "cpu", "host", chunk_steps=3)
    assert appended == [2, 2, 1]
    np.testing.assert_array_equal(np.asarray(store), dense.numpy())
    # one step per chunk: the dropped steps append empty chunks, which the
    # row gather steps over
    store = common.run_inversion(lambda i: rows[i], keep, ROW, "cpu", "host", chunk_steps=1)
    np.testing.assert_array_equal(store.gather_rows([4, 1, 2]).numpy(), dense.numpy()[[4, 1, 2]])
    np.testing.assert_array_equal(dense[:, 0, 0, 0, 0, 0].numpy(), [0, 2, 3, 5, 6])
    with pytest.raises(ValueError, match="traj_store"):
        common.run_inversion(lambda i: rows[i], keep, ROW, "cpu", "disk")
