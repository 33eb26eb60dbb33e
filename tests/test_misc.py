"""DataFormat parsing, quantizer, grid_weight_render, dataformat options."""

import jax.numpy as jnp
import numpy as np
import pytest

import svox_t_tpu as st
from svox_t_tpu.native import quantize_median_cut
from svox_t_tpu.utils.spec import get_out_data_dim


def test_dataformat_parsing():
    f = st.DataFormat("RGBA")
    assert f.format == st.DataFormat.RGBA and f.basis_dim == -1
    f = st.DataFormat("SH9")
    assert f.format == st.DataFormat.SH and f.basis_dim == 9
    f = st.DataFormat("SG16")
    assert f.format == st.DataFormat.SG and f.basis_dim == 16
    f = st.DataFormat("ASG25")
    assert f.format == st.DataFormat.ASG and f.basis_dim == 25
    assert repr(st.DataFormat("SH4")) == "SH4"
    # unrecognized alpha prefix with digits -> RGBA (parity with reference)
    f = st.DataFormat("FOO3")
    assert f.format == st.DataFormat.RGBA


def test_get_out_data_dim():
    assert get_out_data_dim(st.DataFormat.RGBA, -1, 4) == 4
    assert get_out_data_dim(st.DataFormat.SH, 9, 28) == 4
    assert get_out_data_dim(st.DataFormat.SH, 4, 13) == 4
    assert get_out_data_dim(st.DataFormat.SH, 1, 4) == 4


def test_quantize_median_cut_basic(rng):
    # two well-separated clusters, order=1 -> 2 colors
    a = rng.randn(50, 3) * 0.1
    b = rng.randn(50, 3) * 0.1 + 10.0
    data = np.concatenate([a, b]).astype(np.float32)
    colors, ids = quantize_median_cut(data, order=1)
    assert colors.shape == (2, 3) and ids.shape == (100,)
    # each cluster maps to one color
    assert len(set(ids[:50])) == 1 and len(set(ids[50:])) == 1
    assert ids[0] != ids[50]
    got = sorted(colors[:, 0])
    np.testing.assert_allclose(got, [a[:, 0].mean(), b[:, 0].mean()], atol=0.2)


def test_quantize_median_cut_weighted(rng):
    data = rng.rand(64, 4).astype(np.float32)
    w = np.abs(rng.rand(64)).astype(np.float32)
    colors, ids = quantize_median_cut(data, w, order=3)
    assert colors.shape == (8, 4)
    assert ids.min() >= 0 and ids.max() <= 7
    # each cluster's color is the weighted mean of its members
    for c in range(8):
        m = ids == c
        if m.sum() == 0:
            continue
        want = (w[m, None] * data[m]).sum(0) / w[m].sum()
        np.testing.assert_allclose(colors[c], want, atol=1e-4)


def test_quantize_native_matches_numpy(rng):
    from svox_t_tpu.native import quantize as qmod

    data = rng.rand(128, 3).astype(np.float32)
    w = np.abs(rng.rand(128)).astype(np.float32)
    c1, i1 = qmod._quantize_numpy(data, w, 2)
    c2, i2 = quantize_median_cut(data, w, 2)
    # partitions can differ at exact-tie boundaries; compare cluster means
    np.testing.assert_allclose(np.sort(c1, 0), np.sort(c2, 0), atol=1e-3)


def test_grid_weight_render(rng):
    reso = 16
    data = np.zeros((reso, reso, reso), np.float32)
    data[6:10, 6:10, 6:10] = 20.0  # solid block in the middle
    cam_pose = np.eye(4, dtype=np.float32)
    cam_pose[:3, 3] = [0.5, 0.5, 3.0]
    cam = st.CameraSpec(c2w=jnp.asarray(cam_pose), fx=30.0, fy=30.0, width=24, height=24)
    opt = st.RenderOptions(step_size=1e-3, sigma_thresh=1e-4, max_steps=256)
    offset = jnp.zeros(3)
    scaling = jnp.ones(3)
    gw, gh = st.grid_weight_render(jnp.asarray(data), cam, opt, offset, scaling)
    gw, gh = np.asarray(gw), np.asarray(gh)
    assert gw.shape == (reso, reso, reso)
    # weights concentrate on the front face of the block
    assert gw[6:10, 6:10, 9].max() > 0.5
    # voxels behind the block got much less weight
    assert gw[6:10, 6:10, 6].max() < gw[6:10, 6:10, 9].max()
    assert gh.sum() > 0
    assert gw.max() <= 1.0 + 1e-5


def test_renderoptions_hashable():
    o1 = st.RenderOptions(step_size=1e-3)
    o2 = st.RenderOptions(step_size=1e-3)
    assert hash(o1) == hash(o2) and o1 == o2


def _write_trace(root, processes, events):
    """A minimal profiler trace: {pid: name}, [(pid, tid, name, ts, dur)]
    with thread names given as events of dur None."""
    import gzip
    import json
    import os

    d = os.path.join(root, "plugins", "profile", "run")
    os.makedirs(d)
    ev = [{"ph": "M", "pid": p, "name": "process_name",
           "args": {"name": n}} for p, n in processes.items()]
    for pid, tid, name, ts, dur in events:
        if dur is None:
            ev.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})
        else:
            ev.append({"ph": "X", "pid": pid, "tid": tid, "name": name,
                       "ts": ts, "dur": dur})
    with gzip.open(os.path.join(d, "host.trace.json.gz"), "wt") as fh:
        json.dump({"traceEvents": ev}, fh)


def test_profiling_trace_capture(tmp_path):
    """The trace reduction sums the GPU device's stream events, ignores
    host threads and module-span threads, and computes busy share as
    the union of op intervals over the device window."""
    from svox_t_tpu.utils.profiling import TraceResult

    _write_trace(str(tmp_path), {1: "/host:CPU", 2: "/device:GPU:0"}, [
        (1, 1, "python", 0, None),
        (1, 1, "host_work", 0, 500.0),
        (2, 7, "Stream #7(compute)", 0, None),
        (2, 9, "XLA Modules", 0, None),
        (2, 7, "fusion_1", 100.0, 200.0),
        (2, 7, "fusion_2", 250.0, 100.0),   # overlaps fusion_1
        (2, 7, "fusion_1", 600.0, 100.0),
        (2, 9, "jit_render", 100.0, 600.0),
    ])
    t = TraceResult(str(tmp_path))
    assert t.threads == ["Stream #7(compute)"]
    assert t.counts == {"fusion_1": 2, "fusion_2": 1}
    assert abs(t.total_ms - 0.4) < 1e-9
    assert abs(t.busy_ms - 0.35) < 1e-9        # [100,350] + [600,700]
    assert abs(t.window_ms - 0.6) < 1e-9       # 100 .. 700
    assert abs(t.busy_share - 0.35 / 0.6) < 1e-9
    assert t.top(1)[0][0] == "fusion_1"


def test_profiling_raises_without_device_plane(tmp_path):
    """A trace with host events only (work that never reached a GPU)
    raises instead of reporting zero device time."""
    from svox_t_tpu.utils.profiling import TraceResult

    _write_trace(str(tmp_path), {1: "/host:CPU"}, [
        (1, 1, "python", 0, None),
        (1, 1, "host_work", 0, 500.0),
    ])
    with pytest.raises(ValueError, match="no GPU device"):
        TraceResult(str(tmp_path))


def test_device_trace_on_cpu_raises(tmp_path):
    """A real capture on the CPU backend has no GPU device plane."""
    import jax.numpy as jnp

    from svox_t_tpu.utils.profiling import device_trace

    with pytest.raises(ValueError, match="no GPU device"):
        with device_trace(str(tmp_path / "tr")):
            x = jnp.arange(1024.0)
            float(jnp.sum(x * x))
