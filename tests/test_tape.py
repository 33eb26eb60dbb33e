"""Recorded sample tapes (ops/tape.py): replay parity with the march.

Contract under test (module docstring of ops/tape.py):
  * compact=False tapes replay BIT-identically to `volume_render`
    (round boundaries preserved; skipped rounds are exact no-ops).
  * compact=True tapes drop empty crossings — exact 1.0 attenuation
    factors — so outputs agree up to cumprod regrouping (~1e-6, the
    same license as RenderOptions.round_size).
  * gradients through the tape VJP match the march VJP.
  * geometry/structure staleness is detected, not silently wrong.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import svox_t_tpu as st
from svox_t_tpu.ops import tape as tape_ops
from svox_t_tpu.ops.render import (volume_render,
                                   volume_render_with_weight_accum)

from helpers import build_tree, make_rays


def _shell_occupy(c):
    r = np.linalg.norm(c - 0.5, axis=-1)
    return (r > 0.22) & (r < 0.42)


def _scene(rng, N=2, data_format="SH9", data_dim=28, partial=True,
           **kw):
    t, feats, _ = build_tree(
        rng, N=N, data_dim=data_dim, depth_limit=5, n_random_refines=2,
        data_format=data_format,
        occupy=_shell_occupy if partial else None, **kw,
    )
    return t, feats


@pytest.fixture
def rng():
    return np.random.RandomState(7)


@pytest.mark.parametrize("fast", [False, True])
def test_uncompacted_replay_bit_exact(rng, fast):
    """compact=False replay == the march, BITWISE, on a partially
    occupied scene (both exact and fast geometry)."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 257)  # non-multiple of chunk: exercises padding
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(fast), chunk_size=64)
    spec = t._baked_spec()
    ref = np.asarray(volume_render(spec, feats, rays.origins, rays.dirs,
                                   rays.viewdirs, opt))
    tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                              rays.dirs, rays.viewdirs, opt, compact=False)
    out = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("fast", [False, True])
def test_compact_replay_close_and_smaller(rng, fast):
    t, feats = _scene(rng)
    rays = make_rays(rng, 256)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(fast), chunk_size=64)
    spec = t._baked_spec()
    ref = np.asarray(volume_render(spec, feats, rays.origins, rays.dirs,
                                   rays.viewdirs, opt))
    tp_u = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                                rays.dirs, rays.viewdirs, opt,
                                compact=False)
    tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                              rays.dirs, rays.viewdirs, opt, compact=True)
    assert tp.n_samples < tp_u.n_samples  # empties actually dropped
    out = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))
    np.testing.assert_allclose(out, ref, atol=2e-6)


@pytest.mark.parametrize("compact", [False, True])
def test_stop_program_matches_while(rng, compact):
    """Early-stop replay: the flat round PROGRAM (tape_stop_program=1)
    and the retiring while (=0, default) are the same computation —
    post-stop program rounds are exact no-ops — so outputs match
    BITWISE, and both match the march (bitwise when uncompacted)."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 256)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(True), chunk_size=64,
                              tape_stop_program=1)
    assert opt.stop_thresh > 0.0
    spec = t._baked_spec()
    tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                              rays.dirs, rays.viewdirs, opt,
                              compact=compact)
    out_p = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))
    opt_w = dataclasses.replace(opt, tape_stop_program=0)
    out_w = np.asarray(tape_ops.replay_render(tp, feats, opt_w, spec))
    np.testing.assert_array_equal(out_p, out_w)
    if not compact:
        ref = np.asarray(volume_render(spec, feats, rays.origins,
                                       rays.dirs, rays.viewdirs, opt))
        np.testing.assert_array_equal(out_p, ref)


def test_tree_backend_tape_matches_baked(rng):
    """Tapes recorded from the TREE-walk spec equal those from the baked
    spec (same samples, same replay output bitwise)."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 128)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(False), chunk_size=64)
    tp_b = tape_ops.record_tape(t._baked_spec(), feats.shape[0],
                                rays.origins, rays.dirs, rays.viewdirs,
                                opt, compact=False)
    tp_t = tape_ops.record_tape(t._spec(), feats.shape[0], rays.origins,
                                rays.dirs, rays.viewdirs, opt,
                                compact=False)
    out_b = np.asarray(tape_ops.replay_render(tp_b, feats, opt))
    out_t = np.asarray(tape_ops.replay_render(tp_t, feats, opt))
    np.testing.assert_array_equal(out_b, out_t)


@pytest.mark.parametrize("fast", [False, True])
def test_tape_gradients_match_march(rng, fast):
    """Tape VJP (single-pass exact; march-backward fallback for
    thresholded) == march VJP."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 192)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(fast), chunk_size=64)
    spec = t._baked_spec()
    tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                              rays.dirs, rays.viewdirs, opt, compact=True)

    def loss_m(f):
        return jnp.sum(volume_render(spec, f, rays.origins, rays.dirs,
                                     rays.viewdirs, opt) ** 2)

    def loss_t(f):
        return jnp.sum(tape_ops.replay_render(tp, f, opt, spec) ** 2)

    g1 = np.asarray(jax.grad(loss_m)(feats))
    g2 = np.asarray(jax.grad(loss_t)(feats))
    scale = max(np.abs(g1).max(), 1e-9)
    np.testing.assert_allclose(g2 / scale, g1 / scale, atol=3e-6)


@pytest.mark.parametrize("compact", [False, True])
def test_bulk_scatter_backward_matches_tiered(rng, compact):
    """`bwd_bulk_scatter=1` (grad rows as scan ys + one bulk flush) is a
    pure scatter-strategy change: grads match the tiered ladder up to
    scatter-add summation order (exactly equal on this scene)."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 192)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(False), chunk_size=64)
    spec = t._baked_spec()
    tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                              rays.dirs, rays.viewdirs, opt,
                              compact=compact)
    opt = dataclasses.replace(opt, bwd_bulk_scatter=0)
    opt_b = dataclasses.replace(opt, bwd_bulk_scatter=1)

    def loss(f, op):
        return jnp.sum(tape_ops.replay_render(tp, f, op, spec) ** 2)

    g1 = np.asarray(jax.grad(loss)(feats, opt))
    g2 = np.asarray(jax.grad(loss)(feats, opt_b))
    scale = max(np.abs(g1).max(), 1e-9)
    np.testing.assert_allclose(g2 / scale, g1 / scale, atol=1e-6)


def test_tape_grad_unsorted_order(rng):
    """Gradients with unsort=False (tape-order loss over real rows) match
    the unsorted path when padding rows get zero cotangent."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 100)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(False), chunk_size=64)
    spec = t._baked_spec()
    tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                              rays.dirs, rays.viewdirs, opt, compact=True)

    def loss_sorted(f):
        out = tape_ops.replay_render(tp, f, opt, spec, unsort=False)
        return jnp.sum(out[tp.inv_pos] ** 2)

    def loss(f):
        return jnp.sum(tape_ops.replay_render(tp, f, opt, spec) ** 2)

    g1 = np.asarray(jax.grad(loss)(feats))
    g2 = np.asarray(jax.grad(loss_sorted)(feats))
    np.testing.assert_array_equal(g1, g2)


def test_weight_accum_parity(rng):
    t, feats = _scene(rng)
    rays = make_rays(rng, 128)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(False), chunk_size=64)
    spec = t._baked_spec()
    _, wa_ref = volume_render_with_weight_accum(
        spec, feats, rays.origins, rays.dirs, rays.viewdirs, opt)
    tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                              rays.dirs, rays.viewdirs, opt, compact=False)
    _, wa = tape_ops.replay_render_weighted(tp, feats, opt, spec)
    np.testing.assert_allclose(np.asarray(wa), np.asarray(wa_ref),
                               atol=1e-5)


def test_nonpow2_and_rgba(rng):
    """N=3 + RGBA tape replay, bit-exact uncompacted."""
    t, feats = _scene(rng, N=3, data_format="RGBA", data_dim=4)
    rays = make_rays(rng, 96)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(False), chunk_size=32)
    spec = t._baked_spec()
    ref = np.asarray(volume_render(spec, feats, rays.origins, rays.dirs,
                                   rays.viewdirs, opt))
    tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                              rays.dirs, rays.viewdirs, opt, compact=False)
    out = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))
    np.testing.assert_array_equal(out, ref)


def test_transformation_matrices(rng):
    """Per-voxel basis rotation path through the tape (gi_flat comes
    from the tape's idx)."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 64)
    M = feats.shape[0]
    tm = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    ang = rng.rand(M).astype(np.float32) * 0.5
    tm[:, 0, 0] = np.cos(ang); tm[:, 0, 1] = -np.sin(ang)
    tm[:, 1, 0] = np.sin(ang); tm[:, 1, 1] = np.cos(ang)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(False), chunk_size=32)
    spec = t._baked_spec(transformation_matrices=jnp.asarray(tm))
    ref = np.asarray(volume_render(spec, feats, rays.origins, rays.dirs,
                                   rays.viewdirs, opt))
    tp = tape_ops.record_tape(spec, M, rays.origins, rays.dirs,
                              rays.viewdirs, opt, compact=False)
    out = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))
    np.testing.assert_array_equal(out, ref)


def test_empty_pool_and_miss_rays(rng):
    t, feats = _scene(rng)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(False), chunk_size=32)
    spec = t._baked_spec()
    # rays pointing away from the volume
    o = np.full((40, 3), 5.0, np.float32)
    d = np.tile(np.asarray([1.0, 0, 0], np.float32), (40, 1))
    tp = tape_ops.record_tape(spec, feats.shape[0], o, d, d, opt)
    out = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))
    np.testing.assert_allclose(out[:, :-1], 1.0)
    np.testing.assert_allclose(out[:, -1], 0.0)
    # empty feature pool
    tp0 = tape_ops.record_tape(spec, 0, o, d, d, opt)
    out0 = np.asarray(
        tape_ops.replay_render(tp0, jnp.zeros((0, 28), jnp.float32), opt,
                               spec)
    )
    np.testing.assert_allclose(out0[:, -1], 0.0)


def test_stale_tape_guards(rng):
    t, feats = _scene(rng)
    rays = make_rays(rng, 32)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(False), chunk_size=32)
    spec = t._baked_spec()
    tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                              rays.dirs, rays.viewdirs, opt)
    # wrong pool size (structure changed)
    with pytest.raises(ValueError, match="re-record"):
        tape_ops.replay_render(tp, jnp.zeros((feats.shape[0] + 3, 28)),
                               opt, spec)
    # wrong geometry (step size)
    with pytest.raises(ValueError, match="geometry"):
        tape_ops.replay_render(
            tp, feats, dataclasses.replace(opt, step_size=2e-3), spec)


def test_max_steps_cap(rng):
    """Tapes honor the march's exact step cap (incl. ragged caps)."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 64)
    r = st.VolumeRenderer(t)
    spec = t._baked_spec()
    for ms in (7, 12):
        opt = dataclasses.replace(r._get_options(False), chunk_size=32,
                                  max_steps=ms)
        ref = np.asarray(volume_render(spec, feats, rays.origins,
                                       rays.dirs, rays.viewdirs, opt))
        tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                                  rays.dirs, rays.viewdirs, opt,
                                  compact=False)
        out = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))
        np.testing.assert_array_equal(out, ref)


def test_renderer_tape_api(rng):
    """VolumeRenderer.record_rays / render_tape / render_persp_tape."""
    t, feats = _scene(rng)
    r = st.VolumeRenderer(t, chunk_size=64)
    rays = make_rays(rng, 128)
    ref = np.asarray(r(feats, rays))
    tp = r.record_rays(rays, features=feats, compact=False)
    out = np.asarray(r.render_tape(tp, feats))
    np.testing.assert_array_equal(out, ref)

    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.6
    img_ref = np.asarray(r.render_persp(feats, c2w, 24, 20, 24.0))
    img = np.asarray(r.render_persp_tape(feats, c2w, 24, 20, 24.0,
                                         compact=False))
    assert img.shape == img_ref.shape
    np.testing.assert_array_equal(img, img_ref)
    # cached on second call
    n_cached = len(r._tape_cache)
    _ = r.render_persp_tape(feats, c2w, 24, 20, 24.0, compact=False)
    assert len(r._tape_cache) == n_cached
    # structure change invalidates via the key (tree._ver)
    t.refine(sel=tuple(t._all_leaves()[:1].T))
    centers = t[:].corners_local + 0.5 * t[:].lengths_local[:, None]
    centers = np.asarray(
        jax.device_get(t.tree2world(jnp.asarray(centers))))
    centers = centers[_shell_occupy(centers)]
    t.construct_tree(centers)
    f2 = jnp.asarray(
        np.random.RandomState(0).randn(centers.shape[0], 28)
        .astype(np.float32))
    img2 = np.asarray(r.render_persp_tape(f2, c2w, 24, 20, 24.0,
                                          compact=False))
    img2_ref = np.asarray(r.render_persp(f2, c2w, 24, 20, 24.0))
    np.testing.assert_array_equal(img2, img2_ref)


def test_renderer_rig_tape(rng):
    """Multi-view rig tape: one tape over V cameras replays the whole
    rig in one dispatch, each view equal to its single-camera render;
    frames-over-rig composes; grads flow; rig cache hits."""
    t, feats = _scene(rng)
    r = st.VolumeRenderer(t, chunk_size=64)
    c2ws = []
    for dz, dx in ((2.5, 0.5), (2.4, 0.6), (2.6, 0.4)):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [dx, 0.5, dz]  # looking down -z at the volume
        c2ws.append(c2w)
    c2ws = np.stack(c2ws)
    W, H = 24, 20

    imgs = np.asarray(r.render_persp_rig_tape(feats, c2ws, W, H, 24.0,
                                              compact=False))
    assert imgs.shape == (3, H, W, 4)
    for v in range(3):
        # Same recorder raygen -> bitwise, despite the rig tape sorting
        # all views' rays into shared chunks.
        ref_tape = np.asarray(r.render_persp_tape(feats, c2ws[v], W, H,
                                                  24.0, compact=False))
        np.testing.assert_array_equal(imgs[v], ref_tape)
        # vs the fused-raygen one-dispatch render: the documented
        # cross-program raygen ulp caveat (CLAUDE.md conventions).
        ref = np.asarray(r.render_persp(feats, c2ws[v], W, H, 24.0))
        np.testing.assert_allclose(imgs[v], ref, atol=2e-6)

    n_cached = len(r._tape_cache)
    tape = r.record_persp_rig(c2ws, W, H, 24.0, features=feats,
                              compact=False)
    assert len(r._tape_cache) == n_cached  # cache hit, no re-record

    # frames x rig in one dispatch: frame 0 == the static rig render
    stack = jnp.stack([feats, feats * 1.1])
    out = np.asarray(r.render_tape_frames(tape, stack))
    assert out.shape == (2, 3 * W * H, 4)
    np.testing.assert_array_equal(
        out[0].reshape(3, H, W, 4), imgs)

    g = jax.grad(lambda f: jnp.sum(
        r.render_tape(tape, f) ** 2))(feats)
    assert np.isfinite(np.asarray(g)).all() and float(
        jnp.abs(g).max()) > 0


def test_render_tape_frames(rng):
    """T-frame stack over one tape == per-frame replay == render_frames
    (bitwise with an uncompacted tape), incl. per-frame tmats and grads."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 96)
    r = st.VolumeRenderer(t, chunk_size=32)
    T, M = 3, feats.shape[0]
    stack = jnp.stack([feats * (1.0 + 0.1 * i) for i in range(T)])
    tm = np.tile(np.eye(4, dtype=np.float32), (T, M, 1, 1))
    tm[1, :, 0, 0] = np.cos(0.3); tm[1, :, 0, 1] = -np.sin(0.3)
    tm[1, :, 1, 0] = np.sin(0.3); tm[1, :, 1, 1] = np.cos(0.3)
    ref = np.asarray(r.render_frames(stack, rays,
                                     transformation_matrices_frames=tm))
    tp = r.record_rays(rays, features=feats, compact=False)
    out = np.asarray(r.render_tape_frames(tp, stack,
                                          transformation_matrices_frames=tm))
    np.testing.assert_array_equal(out, ref)

    g1 = np.asarray(jax.grad(
        lambda s: jnp.sum(r.render_frames(s, rays) ** 2))(stack))
    g2 = np.asarray(jax.grad(
        lambda s: jnp.sum(r.render_tape_frames(tp, s) ** 2))(stack))
    scale = max(np.abs(g1).max(), 1e-9)
    np.testing.assert_allclose(g2 / scale, g1 / scale, atol=3e-6)


def test_sharded_tape_replay_matches_single(rng):
    """Tape replay with rays-within-chunk sharded over the 8-device mesh
    == single-device replay exactly; the tape train step decreases loss
    and its grads match single-device tape grads."""
    from svox_t_tpu.parallel import (make_ray_mesh, make_tape_train_step,
                                     replay_sharded, shard_tape)

    t, feats = _scene(rng)
    rays = make_rays(rng, 256)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(False), chunk_size=64)
    spec = t._baked_spec()
    tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                              rays.dirs, rays.viewdirs, opt, compact=True)
    single = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))

    mesh = make_ray_mesh()
    assert mesh.shape["rays"] == 8
    out = np.asarray(replay_sharded(mesh, tp, feats, opt, spec))
    np.testing.assert_array_equal(out, single)

    import optax

    tps = shard_tape(mesh, tp)
    target = jnp.zeros((tp.n_chunks * tp.C, single.shape[1]))
    # sgd(1.0): the post-step pool difference IS the gradient (an lr
    # below 1 would amplify the f32 subtraction noise when recovering it)
    step = make_tape_train_step(mesh, opt, optimizer=optax.sgd(1.0))
    state = step.init(feats)
    g_single = np.asarray(jax.grad(
        lambda f: 0.5 * jnp.mean(
            (tape_ops.replay_render(tp, f, opt, spec, unsort=False)
             - target) ** 2))(feats))
    state2, loss1 = step(state, tps, spec, target)
    (f2, _), loss1 = state2, float(loss1)
    g_sharded = np.asarray(feats) - np.asarray(f2)
    np.testing.assert_allclose(g_sharded, g_single, atol=1e-6)


def test_pool_sharded_tape_replay_matches_single(rng):
    """MP: tape replay with the feature POOL row-sharded (per-round
    psum) == single-device replay exactly, and grads through the replay
    VJP match for BOTH flush strategies (the bulk ys flush must keep
    non-owned rows on the drop slot under sharding)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from svox_t_tpu.parallel import shard_pool

    t, feats = _scene(rng)
    rays = make_rays(rng, 128)
    r = st.VolumeRenderer(t)
    opt0 = dataclasses.replace(r._get_options(False), chunk_size=64)
    spec = t._baked_spec()
    M = feats.shape[0]
    tp = tape_ops.record_tape(spec, M, rays.origins, rays.dirs,
                              rays.viewdirs, opt0, compact=True)
    single = np.asarray(tape_ops.replay_render(tp, feats, opt0, spec))
    g1 = np.asarray(jax.grad(lambda f: jnp.sum(
        tape_ops.replay_render(tp, f, opt0, spec) ** 2))(feats))

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("pool",))
    fshard, _ = shard_pool(mesh, feats)

    for bulk in (0, 1):
        opt2 = dataclasses.replace(
            opt0, pool_axis="pool", pool_rows=M, bwd_bulk_scatter=bulk
        )
        sm = shard_map(
            lambda tp_, f_: tape_ops.replay_render(tp_, f_, opt2, spec),
            mesh=mesh, in_specs=(P(), P("pool")), out_specs=P(),
        )
        out = np.asarray(jax.jit(sm)(tp, fshard))
        np.testing.assert_array_equal(out, single)
        g2 = np.asarray(jax.jit(jax.grad(
            lambda f: jnp.sum(sm(tp, f) ** 2)))(fshard))[:M]
        scale = max(np.abs(g1).max(), 1e-9)
        np.testing.assert_allclose(g2 / scale, g1 / scale, atol=1e-6)


def test_quantized_pool_replay(rng):
    t, feats = _scene(rng)
    rays = make_rays(rng, 64)
    r = st.VolumeRenderer(t, chunk_size=64)
    qf = st.quantize_features(feats)
    ref = np.asarray(r(qf, rays))
    tp = r.record_rays(rays, n_features=feats.shape[0], compact=False)
    out = np.asarray(r.render_tape(tp, qf))
    np.testing.assert_array_equal(out, ref)


def test_block_grouped_persp_tape(rng):
    """Pixel-block grouped tapes (the record_persp default): rays are
    recorded in (bh x bw) block-major order and the count sort moves
    whole blocks, so the output unsort is a block gather + transpose.
    Outputs must be BITWISE equal to the legacy ray-level sort (the
    per-ray radiometry never depends on chunk membership), inv_pos must
    stay a valid pixel-level map, grads must match, and non-divisible
    image sizes must fall back to the legacy path."""
    t, feats = _scene(rng)
    r = st.VolumeRenderer(t, chunk_size=64)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.6
    W, H = 24, 20

    ref = np.asarray(r.render_persp_tape(feats, c2w, W, H, 24.0,
                                         group_size=1))
    for G in (8, 16, 32):
        tp = r.record_persp(c2w, W, H, 24.0, features=feats,
                            group_size=G)
        assert tp.group == G and tp.out_blocks, (G, tp.group)
        nbh, nbw, bh, bw = tp.out_blocks
        assert (bh * bw == G and nbh * bh == H and nbw * bw == W)
        img = np.asarray(r.render_persp_tape(feats, c2w, W, H, 24.0,
                                             group_size=G))
        np.testing.assert_array_equal(img.reshape(-1, img.shape[-1]),
                                      ref.reshape(-1, ref.shape[-1]))
        # inv_pos is still the pixel-level map into the sorted layout
        srt = np.asarray(r.render_tape(tp, feats, unsort=False))
        np.testing.assert_array_equal(
            srt[np.asarray(tp.inv_pos)],
            img.reshape(-1, img.shape[-1]),
        )

    # grads through the block unsort == grads through the row gather
    tp1 = r.record_persp(c2w, W, H, 24.0, features=feats, group_size=1)
    tp32 = r.record_persp(c2w, W, H, 24.0, features=feats, group_size=32)
    g1 = np.asarray(jax.grad(lambda f: jnp.sum(
        r.render_tape(tp1, f) ** 2))(feats))
    g32 = np.asarray(jax.grad(lambda f: jnp.sum(
        r.render_tape(tp32, f) ** 2))(feats))
    np.testing.assert_array_equal(g1, g32)

    # 25 % 8 != 0: the 2-D block shape is rejected; the fallback keeps
    # the requested grouping as a 1-D grouped sort over PIXEL-order rays
    # (degraded to the largest compatible divisor) instead of silently
    # dropping it — outputs still come back in raster order.
    tp_odd = r.record_persp(c2w, 25, H, 24.0, features=feats,
                            group_size=32)
    assert not tp_odd.out_blocks and tp_odd.group > 1
    img_odd = np.asarray(r.render_persp_tape(feats, c2w, 25, H, 24.0,
                                             group_size=32))
    ref_odd = np.asarray(r.render_persp(feats, c2w, 25, H, 24.0))
    np.testing.assert_allclose(img_odd, ref_odd, atol=2e-6)

    # rig tapes group the same way (the -1 reshape absorbs the views)
    c2ws = np.stack([c2w, c2w])
    rig = np.asarray(r.render_persp_rig_tape(feats, c2ws, W, H, 24.0,
                                             group_size=16))
    for v in range(2):
        np.testing.assert_array_equal(rig[v], ref)
