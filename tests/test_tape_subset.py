"""Row-subset tape replay (ops/tape_subset.py).

Contract under test (module docstring of ops/tape_subset.py):
  * a subset replay of rays R equals the full replay restricted to R —
    bitwise for compact=False parents (re-chunking regroups only
    identical recorded slot values at the march's own round size), to
    the ~1e-6 regroup license for compacted ones;
  * subset gradients equal the full replay's gradient of a loss masked
    to R (the reference trains on arbitrary ray batches,
    svox_t/renderer.py:207-308 — this is the tape's equivalent);
  * the sequential minibatch trainer's chain matches an eager
    per-step subset-replay SGD loop;
  * duplicates, tiny subsets, and indirect (cell-indexed) parents work.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import svox_t_tpu as st
from svox_t_tpu.ops import tape as tape_ops
from svox_t_tpu.ops import tape_subset as tsub
from svox_t_tpu.ops.render import volume_render

from helpers import build_tree, make_rays


def _shell_occupy(c):
    r = np.linalg.norm(c - 0.5, axis=-1)
    return (r > 0.22) & (r < 0.42)


def _scene(rng, data_format="SH9", data_dim=28):
    t, feats, _ = build_tree(
        rng, N=2, data_dim=data_dim, depth_limit=5, n_random_refines=2,
        data_format=data_format, occupy=_shell_occupy,
    )
    return t, feats


@pytest.fixture
def rng():
    return np.random.RandomState(11)


def _record(t, feats, rays, compact=True, chunk=64, **kw):
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(False), chunk_size=chunk)
    spec = t._baked_spec()
    tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                              rays.dirs, rays.viewdirs, opt,
                              compact=compact, **kw)
    return tp, opt, spec


def test_subset_matches_full_replay_uncompacted(rng):
    """compact=False: subset replay rows == full replay rows, BITWISE
    (same recorded slot values, same prog_K round grouping)."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 300)
    tp, opt, spec = _record(t, feats, rays, compact=False)
    full = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))
    ids = rng.choice(300, size=96, replace=False)
    sub = tsub.subset_tape(tp, ids, chunk_size=32)
    out = np.asarray(tape_ops.replay_render(sub, feats, opt, spec))
    np.testing.assert_array_equal(out, full[ids])


def test_subset_matches_full_replay_compact(rng):
    t, feats = _scene(rng)
    rays = make_rays(rng, 300)
    tp, opt, spec = _record(t, feats, rays, compact=True)
    full = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))
    ids = rng.choice(300, size=128, replace=False)
    out = np.asarray(tsub.replay_render_rows(tp, ids, feats, opt, spec,
                                             chunk_size=32))
    np.testing.assert_array_equal(out, full[ids])


def test_subset_matches_march(rng):
    """Subset replay vs a fresh march of exactly those rays (compact
    regroup license ~1e-6)."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 257)
    tp, opt, spec = _record(t, feats, rays, compact=True)
    ids = rng.choice(257, size=64, replace=False)
    ref = np.asarray(volume_render(
        spec, feats, rays.origins[ids], rays.dirs[ids],
        rays.viewdirs[ids], opt))
    out = np.asarray(tsub.replay_render_rows(tp, ids, feats, opt, spec,
                                             chunk_size=32))
    np.testing.assert_allclose(out, ref, atol=2e-6)


def test_subset_duplicates_and_tiny(rng):
    t, feats = _scene(rng)
    rays = make_rays(rng, 120)
    tp, opt, spec = _record(t, feats, rays)
    full = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))
    ids = np.array([5, 5, 77, 3, 119, 5])
    out = np.asarray(tsub.replay_render_rows(tp, ids, feats, opt, spec,
                                             chunk_size=32))
    np.testing.assert_array_equal(out, full[ids])
    # Single ray: chunk shape collapses to C=1, where eval_basis can
    # round a lane 1 ulp differently (the known batch-shape
    # sensitivity, CLAUDE.md) — value-level equality only.
    out1 = np.asarray(tsub.replay_render_rows(tp, np.array([42]), feats,
                                              opt, spec))
    np.testing.assert_allclose(out1, full[[42]], rtol=1e-6, atol=1e-6)


def test_subset_grad_matches_masked_full(rng):
    """d/dfeatures of sum(subset out) == d/dfeatures of the full replay
    with the loss masked to the subset rows — the defining property of
    minibatch gradients (regroup ulps only)."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 200)
    tp, opt, spec = _record(t, feats, rays)
    ids = rng.choice(200, size=80, replace=False)
    mask = np.zeros((200,), np.float32)
    mask[ids] = 1.0  # ids unique, so mask == multiplicity

    def full_loss(f):
        out = tape_ops.replay_render(tp, f, opt, spec)
        return jnp.sum(out * jnp.asarray(mask)[:, None])

    def sub_loss(f):
        out = tsub.replay_render_rows(tp, ids, f, opt, spec,
                                      chunk_size=32)
        return jnp.sum(out)

    g_full = np.asarray(jax.grad(full_loss)(feats))
    g_sub = np.asarray(jax.grad(sub_loss)(feats))
    np.testing.assert_allclose(g_sub, g_full, rtol=2e-4, atol=2e-6)


def test_subset_grad_matches_march_grad(rng):
    """Subset grads vs the march backward on the identical ray set —
    the parity bar for minibatch training."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 200)
    tp, opt, spec = _record(t, feats, rays)
    ids = rng.choice(200, size=64, replace=False)

    def march_loss(f):
        out = volume_render(spec, f, rays.origins[ids], rays.dirs[ids],
                            rays.viewdirs[ids], opt)
        return jnp.sum(out)

    def sub_loss(f):
        return jnp.sum(tsub.replay_render_rows(tp, ids, f, opt, spec,
                                               chunk_size=32))

    g_ref = np.asarray(jax.grad(march_loss)(feats))
    g_sub = np.asarray(jax.grad(sub_loss)(feats))
    np.testing.assert_allclose(g_sub, g_ref, rtol=3e-4, atol=3e-6)


def test_subset_source_reuse(rng):
    """TapeRowSource built once serves many subsets; results identical
    to per-call conversion."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 150)
    tp, opt, spec = _record(t, feats, rays)
    src = tsub.TapeRowSource(tp)
    full = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))
    for _ in range(3):
        ids = rng.choice(150, size=50, replace=False)
        out = np.asarray(tsub.replay_render_rows(src, ids, feats, opt,
                                                 spec, chunk_size=32))
        np.testing.assert_array_equal(out, full[ids])


def test_subset_indirect_parent(rng):
    """Cell-indexed (indirect) parents subset fine: the subset carries
    the cell stream and resolves through the same index table."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 150)
    r = st.VolumeRenderer(t)
    opt = dataclasses.replace(r._get_options(False), chunk_size=64,
                              box_advance=0)
    spec = t._baked_spec()
    tp = tape_ops.record_tape(spec, feats.shape[0], rays.origins,
                              rays.dirs, rays.viewdirs, opt,
                              compact=True, indirect=True)
    table = tape_ops.pack_index_table(t._spec().data_flat)
    full = np.asarray(tape_ops.replay_render(tp, feats, opt, spec,
                                             index_table=table))
    ids = rng.choice(150, size=60, replace=False)
    out = np.asarray(tsub.replay_render_rows(tp, ids, feats, opt, spec,
                                             index_table=table,
                                             chunk_size=32))
    np.testing.assert_array_equal(out, full[ids])


def test_train_minibatches_matches_eager_chain(rng):
    """The one-dispatch sequential trainer follows the SAME feature
    trajectory as an eager per-step subset-replay SGD loop with the
    FULL per-batch loss (zero-occupancy rays carry zero gradient, so
    excluding their constant loss terms — the trainer's documented
    scope — changes no update)."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 240)
    tp, opt, spec = _record(t, feats, rays)
    src = tsub.TapeRowSource(tp)
    # Ground-truth targets: the full replay under the true features.
    tgt = tape_ops.replay_render(tp, feats, opt, spec)
    n_color = tgt.shape[1] - 1
    tgt = tgt[:, :n_color]
    f0 = feats * 0.8 + 0.05
    N, B, lr = 4, 48, 0.5
    ids_b = np.stack([rng.choice(240, size=B, replace=False)
                      for _ in range(N)])

    f_out, losses, _ = tsub.train_minibatches(
        src, ids_b, tgt, f0, opt, lr=lr, spec=spec, chunk_size=32,
    )
    f_out = np.asarray(f_out)
    losses = np.asarray(losses)
    assert np.isfinite(losses).all()

    # Eager reference chain with the FULL loss (constant terms incl.).
    f = jnp.asarray(f0)
    for n in range(N):
        ids = ids_b[n]

        def loss_fn(ff):
            out = tsub.replay_render_rows(src, ids, ff, opt, spec,
                                          chunk_size=32)
            err = out[:, :n_color] - tgt[ids]
            return jnp.sum(err * err) / (B * n_color)

        _, g = jax.value_and_grad(loss_fn)(f)
        f = f - lr * g

    np.testing.assert_allclose(f_out, np.asarray(f), rtol=2e-4,
                               atol=2e-6)
    # Reported losses cover exactly the non-zero-prefix rows: the gap
    # to the full loss is the zero rays' constant background error.
    occ = src.counts_host[src.inv_host[ids_b[0]]] > 0
    out0 = tsub.replay_render_rows(src, ids_b[0], jnp.asarray(f0), opt,
                                   spec, chunk_size=32)
    err0 = np.asarray(out0)[:, :n_color] - np.asarray(tgt)[ids_b[0]]
    full0 = float((err0 * err0).sum() / (B * n_color))
    zero0 = float((err0[~occ] ** 2).sum() / (B * n_color))
    # The prefix cut is chunk-granular, so [full - all-zero-terms] <=
    # reported <= full (boundary-chunk zero rays stay included).
    assert full0 - zero0 - 1e-6 <= losses[0] <= full0 + 1e-6


def test_train_minibatches_custom_update(rng):
    """Momentum state threads through the scan."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 120)
    tp, opt, spec = _record(t, feats, rays)
    tgt = np.asarray(tape_ops.replay_render(tp, feats, opt, spec))[:, :3]
    f0 = feats * 0.9

    def momentum(f, g, state):
        v = 0.9 * state - 0.5 * g
        return f + v, v

    f_out, losses, v_out = tsub.train_minibatches(
        tsub.TapeRowSource(tp),
        np.stack([rng.choice(120, size=32) for _ in range(3)]),
        tgt, f0, opt, update_fn=momentum,
        update_state=jnp.zeros_like(f0), spec=spec, chunk_size=32,
    )
    assert np.isfinite(np.asarray(losses)).all()
    assert np.isfinite(np.asarray(f_out)).all()


def test_subset_bad_ids_raise(rng):
    t, feats = _scene(rng)
    rays = make_rays(rng, 64)
    tp, opt, spec = _record(t, feats, rays)
    with pytest.raises(ValueError):
        tsub.subset_tape(tp, np.array([64]))
    with pytest.raises(ValueError):
        tsub.subset_tape(tp, np.array([-1]))
    with pytest.raises(ValueError):
        tsub.subset_tape(tp, np.array([], np.int64))


def test_train_steps_matches_eager_chain(rng):
    """The one-dispatch full-tape SGD chain == an eager per-step
    replay + SGD loop (same targets, same lr)."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 200)
    tp, opt, spec = _record(t, feats, rays)
    tgt_full = tape_ops.replay_render(tp, feats, opt, spec)
    n_color = tgt_full.shape[1] - 1
    tgt = tgt_full[:, :n_color]
    f0 = feats * 0.85
    N, lr = 4, 0.4

    f_out, losses, _ = tsub.train_steps(tp, tgt, f0, opt, N, lr=lr,
                                        spec=spec)
    f_out, losses = np.asarray(f_out), np.asarray(losses)

    f = jnp.asarray(f0)
    B = 200
    ref_losses = []
    for _ in range(N):
        def loss_fn(ff):
            out = tape_ops.replay_render(tp, ff, opt, spec)
            err = out[:, :n_color] - tgt
            return jnp.sum(err * err) / (B * n_color)

        l, g = jax.value_and_grad(loss_fn)(f)
        ref_losses.append(float(l))
        f = f - lr * g

    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(f_out, np.asarray(f), rtol=2e-4,
                               atol=2e-6)
    assert losses[-1] < losses[0]  # same loss every step: must descend


def test_subset_weight_accum(rng):
    """Weight accumulation through a subset (TapeRowSource
    keep_cells=True): equals the march's accumulation over the
    identical rays."""
    from svox_t_tpu.ops.render import volume_render_with_weight_accum

    t, feats = _scene(rng)
    rays = make_rays(rng, 150)
    tp, opt, spec = _record(t, feats, rays)
    src = tsub.TapeRowSource(tp, keep_cells=True)
    ids = rng.choice(150, size=48, replace=False)
    sub = tsub.subset_tape(src, ids, chunk_size=32)
    _, wa_sub = tape_ops.replay_render_weighted(sub, feats, opt, spec)
    _, wa_ref = volume_render_with_weight_accum(
        spec, feats, rays.origins[ids], rays.dirs[ids],
        rays.viewdirs[ids], opt)
    np.testing.assert_allclose(np.asarray(wa_sub), np.asarray(wa_ref),
                               rtol=2e-5, atol=2e-6)
    assert float(np.asarray(wa_sub).sum()) > 0


def test_prep_minibatches_pack_equals_direct(rng):
    """A prep_minibatches pack passed to train_minibatches gives the
    SAME chain as passing raw ids (the pipelining API is pure
    factoring), and a pack from a different source raises."""
    t, feats = _scene(rng)
    rays = make_rays(rng, 160)
    tp, opt, spec = _record(t, feats, rays)
    src = tsub.TapeRowSource(tp)
    tgt = tape_ops.replay_render(tp, feats, opt, spec)[:, :3]
    ids_b = np.stack([rng.choice(160, size=32) for _ in range(3)])
    f0 = feats * 0.9

    f_a, l_a, _ = tsub.train_minibatches(src, ids_b, tgt, f0, opt,
                                         lr=0.2, spec=spec,
                                         chunk_size=32)
    pack = tsub.prep_minibatches(src, ids_b, chunk_size=32)
    f_b, l_b, _ = tsub.train_minibatches(src, pack, tgt, f0, opt,
                                         lr=0.2, spec=spec)
    np.testing.assert_array_equal(np.asarray(f_a), np.asarray(f_b))
    np.testing.assert_array_equal(np.asarray(l_a), np.asarray(l_b))

    # mismatched source raises
    t2, feats2 = _scene(np.random.RandomState(99))
    rays2 = make_rays(np.random.RandomState(98), 160)
    tp2, opt2, spec2 = _record(t2, feats2, rays2, chunk=32)
    src2 = tsub.TapeRowSource(tp2)
    if tsub._SrcMeta.of(src2) != tsub._SrcMeta.of(src):
        with pytest.raises(ValueError, match="different source"):
            tsub.train_minibatches(src2, pack, tgt, f0, opt2, lr=0.2,
                                   spec=spec2)
