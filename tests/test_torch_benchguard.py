"""The port's bench guards and profiling hooks against the JAX package's
(``anyv2v_torch/utils/benchguard.py``, ``utils/profiling.py``).

``hard_sync`` returns the JAX ``hard_sync``'s scalar on the same numpy-seeded
arrays (rtol 1e-6: the same fp32 means, summed in another order), walks
nested dicts, lists, tuples and dataclasses, checks a ``HostTrajectory``'s
chunks, raises on a NaN or Inf anywhere, and raises where the JAX version
returns 0.0: on a non-empty input that holds no tensor, and (through its
chunks) on a host trajectory. ``check_scan_time`` keeps the JAX floor and
message. ``PhaseTimers`` syncs on its ``sync`` outputs at exit. ``trace_if``
writes the profiler's events and the program's spans into one Chrome trace.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anyv2v_tpu.utils import benchguard as jbench
from anyv2v_torch.models.layers import group_norm
from anyv2v_torch.pipelines.common import HostTrajectory
from anyv2v_torch.utils import benchguard
from anyv2v_torch.utils.profiling import PhaseTimers, trace_if

RTOL = 1e-6


@dataclasses.dataclass
class _Out:
    latents: object
    extra: object


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(2, 3, 4).astype(np.float32),
            "b": [rng.randn(5).astype(np.float16), (rng.randn(3, 3).astype(np.float32),
                                                    np.float32(rng.randn()))],
            "c": rng.randint(-4, 9, size=(6,)).astype(np.int32)}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hard_sync_matches_jax(seed):
    arrays = _arrays(seed)
    want = jbench.hard_sync(_map(arrays, jnp.asarray))
    got = benchguard.hard_sync(_map(arrays, lambda a: torch.from_numpy(np.asarray(a))))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # a dataclass holding the same leaves gives the same scalar
    got_dc = benchguard.hard_sync(_Out(_map(arrays["a"], torch.from_numpy),
                                       _map(arrays["b"], lambda a: torch.from_numpy(
                                           np.asarray(a)))))
    want_dc = jbench.hard_sync([jnp.asarray(arrays["a"]), _map(arrays["b"], jnp.asarray)])
    np.testing.assert_allclose(got_dc, want_dc, rtol=RTOL)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_hard_sync_raises_on_non_finite(bad):
    arrays = _arrays(3)
    arrays["a"][1, 2, 3] = bad
    with pytest.raises(FloatingPointError):
        jbench.hard_sync(_map(arrays, jnp.asarray))
    with pytest.raises(FloatingPointError, match="non-finite"):
        benchguard.hard_sync(_map(arrays, lambda a: torch.from_numpy(np.asarray(a))))


def test_hard_sync_checks_a_host_trajectory():
    """The JAX version returns 0.0 for a host trajectory (nothing it knows to
    sync); the port's sums its chunks' means and raises on a NaN chunk."""
    rng = np.random.RandomState(4)
    chunks = [rng.randn(k, 1, 3, 2, 2, 4).astype(np.float32) for k in (2, 3)]
    store = HostTrajectory("cpu")
    for c in chunks:
        store.append(torch.from_numpy(c))
    want = sum(float(np.mean(c, dtype=np.float32)) for c in chunks)
    np.testing.assert_allclose(benchguard.hard_sync(store), want, rtol=RTOL)
    np.testing.assert_allclose(benchguard.hard_sync({"traj": store, "x": torch.ones(3)}),
                               want + 1.0, rtol=RTOL)
    chunks[1][2, 0, 1, 0, 1, 3] = np.nan
    store = HostTrajectory("cpu")
    for c in chunks:
        store.append(torch.from_numpy(c))
    with pytest.raises(FloatingPointError):
        benchguard.hard_sync(store)


@pytest.mark.parametrize("x", [{"steps": 3}, [1.0, 2.0], ("a",), 7, "latents"])
def test_hard_sync_raises_without_a_tensor(x):
    assert jbench.hard_sync(x) == 0.0          # the reference's silent no-op
    with pytest.raises(TypeError, match="no tensor"):
        benchguard.hard_sync(x)


@pytest.mark.parametrize("x", [None, {}, [], ()])
def test_hard_sync_of_nothing_is_zero(x):
    assert benchguard.hard_sync(x) == jbench.hard_sync(x) == 0.0


def test_check_scan_time_keeps_the_floor_and_message():
    assert benchguard.MIN_UNET_STEP_S == jbench.MIN_UNET_STEP_S
    assert benchguard.check_scan_time("edit", 0.5, 50) == 0.5
    for fn in (jbench.check_scan_time, benchguard.check_scan_time):
        with pytest.raises(RuntimeError) as err:
            fn("edit", 0.047, 50)
        if fn is jbench.check_scan_time:
            want = str(err.value)
        else:
            assert str(err.value) == want
    with pytest.raises(RuntimeError, match="implausible"):
        benchguard.check_scan_time("invert", 0.02, 3)
    assert benchguard.check_scan_time("invert", 0.03, 3, min_step_s=0.01) == 0.03


def test_phase_timers_sync_and_report(tmp_path):
    timers = PhaseTimers("cpu")
    out = {}
    with timers.phase("a", sync=out):
        out["x"] = torch.ones(4) * 2
    with timers.phase("a"):
        pass
    rep = timers.report()
    assert set(rep) == {"a"} and rep["a"] >= 0.0 and timers.seconds["a"] >= rep["a"] - 5e-4
    with pytest.raises(FloatingPointError):
        with timers.phase("nan", sync=out):
            out["x"] = torch.full((3,), float("nan"))
    with pytest.raises(TypeError):
        with timers.phase("none", sync={"steps": 5}):
            pass
    with trace_if(None):
        pass
    with trace_if(str(tmp_path / "trace")):
        (torch.ones(8) + 1).sum()
        group_norm(torch.ones(1, 4, 4, 8), torch.nn.GroupNorm(2, 8))
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    # the profiler's events and the program's spans, as a process of their own,
    # on one clock: the span holds the ops it ran
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "anyv2v_torch"]
    assert [s["name"] for s in spans] == ["layer.norm"]
    ops = [e for e in events if e.get("name") == "aten::var_mean"]
    assert ops and spans[0]["pid"] not in {e["pid"] for e in ops}
    start, end = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    assert all(start - 50 <= e["ts"] and e["ts"] + e["dur"] <= end + 50 for e in ops)
    assert any(e.get("ph") == "M" and e.get("args", {}).get("name") == "anyv2v_torch spans"
               for e in events)
