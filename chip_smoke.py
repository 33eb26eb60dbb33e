#!/usr/bin/env python
"""Smoke test of the renderer's main paths on one GPU, at the scale
users deploy.

One process, one card. Phases:

  P0  device: a GPU must be present (no CPU fallback); prints the card's
      name and power limit.
  P1  static serving on a depth-9 (512^3-equivalent) SH9 shell at
      800x800: exact, fast, bf16 and int8 pools; exact vs the scan
      oracle on sampled pixels.
  P2  training on the depth-7 scene: the full-view gradient vs the
      oracle's on a ray subset, run-to-run determinism, three Adam
      steps, one random-ray minibatch super-batch over a 4-view rig.
  P3  recorded tapes: replay vs march (images, frames, gradients).
  P4  animation: the fused LBS loop, its dynamic tape, depth and
      opacity on one frame.
  P5  a device trace of one warm 800x800 exact march frame.

Every comparison prints its largest deviation beside its tolerance and
the reason for it; every phase prints peak device memory and smoke
timings (first call with compilation, then one warm call, each ending
in ``block_until_ready``). These timings are smoke numbers, not
benchmark results. Any failed phase or deviation over its tolerance
makes the run exit non-zero after the remaining phases ran. On success
the last line is one JSON object naming the device.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --multi    # four GPUs: sharded steps only
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# Why each tolerance is what it is. Float32 everywhere (``ops/sh.py``
# forces HIGHEST matmul precision, so TF32 never enters); what remains
# is FMA contraction, fusion and summation order.
TOL = {
    "oracle_fwd": (1e-4, "project accuracy bar vs the reference "
                   "(BASELINE.json); same rays, f32 march vs f32 scan"),
    "fast_vs_exact": (5e-2, "fast mode drops samples with sigma < 1e-2 "
                      "and stops at transmittance < 1e-2 by design"),
    "quant_vs_dequant": (1e-4, "same pool values; only the in-march "
                         "dequantization order differs"),
    "grad_oracle": (1e-4, "relative to the largest gradient entry; the "
                    "hand VJP vs autodiff through the oracle scan"),
    "tape_vs_march": (1e-5, "tape replay runs the march's own radiometry; "
                      "compaction regroups rounds (~1e-7)"),
    "tape_grad": (1e-4, "relative to the largest gradient entry; the tape "
                  "VJP and the march VJP flush in different orders"),
    "minibatch_loss": (1e-4, "relative; first-step loss of the subset "
                       "replay vs the march on the same rays"),
    "aux_vs_march": (1e-5, "opacity/depth passes walk the same samples as "
                     "the colour march"),
    "multi": (1e-5, "relative to the largest entry; per-device partial "
              "sums are combined by psum in another order"),
}


class Report:
    """Collects checks and failures; prints one line per item."""

    def __init__(self, card: str = "unknown card"):
        self.card = card
        self.failures = []

    def check(self, phase, what, dev, key, scale=None):
        """Record max deviation ``dev`` (relative to ``scale`` if given)
        against TOL[key]."""
        tol, why = TOL[key]
        rel = "" if scale is None else " (relative)"
        val = float(dev) if scale is None else float(dev) / max(float(scale), 1e-30)
        ok = bool(np.isfinite(val) and val <= tol)
        print(f"[{phase}] {what}: max dev {val:.3e}{rel} "
              f"{'<=' if ok else 'EXCEEDS'} tol {tol:.0e} -- {why}",
              flush=True)
        if not ok:
            self.failures.append(f"{phase}: {what} {val:.3e} > {tol:.0e}")

    def require(self, phase, what, cond):
        print(f"[{phase}] {what}: {'ok' if cond else 'FAILED'}", flush=True)
        if not cond:
            self.failures.append(f"{phase}: {what}")

    def timing(self, phase, what, first_s, warm_s):
        print(f"[{phase}] smoke timing on {self.card}: {what}: first call "
              f"(compile+run) {first_s:.3f} s, warm {warm_s * 1e3:.3f} ms",
              flush=True)

    def memory(self, phase, device=None):
        import jax

        dev = device or jax.devices()[0]
        stats = dev.memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        txt = "not reported" if peak is None else f"{peak / 2**30:.3f} GiB"
        print(f"[{phase}] peak device memory ({dev.device_kind}): {txt}",
              flush=True)


def timed(fn):
    """(result, first_s, warm_s): two calls, each ending in
    block_until_ready; the first includes tracing and compilation."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, first, time.perf_counter() - t0


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _camera_rays(c2w, width, fx):
    """Pixel-order rays of a square image, generated once on device."""
    import jax

    from svox_t_tpu.ops.render import cam2world_rays

    return jax.jit(cam2world_rays, static_argnums=(1, 2, 3, 4))(
        c2w, width, width, fx, fx)


def _l2(out, target):
    import jax.numpy as jnp

    return jnp.mean((out - target) ** 2)


# ---------------------------------------------------------------------------
# P1: static serving at PlenOctree scale
# ---------------------------------------------------------------------------


def phase_static(rep: Report, depth=9, width=800, n_check=4096, seed=0):
    import jax
    import jax.numpy as jnp

    import svox_t_tpu as st
    from benchmarks.scenes import build_shell_tree, orbit_camera
    from svox_t_tpu.models.renderer import _persp_jit, _tile_order
    from svox_t_tpu.ops.reference_renderer import volume_render_oracle

    P = "P1"
    t0 = time.perf_counter()
    tree, feats = build_shell_tree(depth=depth, data_format="SH9",
                                   data_dim=28)
    r = st.VolumeRenderer(tree, step_size=1e-3)
    baked = tree._baked_spec()
    print(f"[{P}] depth-{depth} SH9 shell: {feats.shape[0]} feature rows "
          f"({feats.size * 4 / 1e6:.1f} MB f32 pool), {tree.n_leaves} leaves;"
          f" host build + bake {time.perf_counter() - t0:.2f} s", flush=True)
    c2w = orbit_camera()
    fx = width * 1.1
    opt = r._get_options(False)

    perm, inv = _tile_order(opt, width, width)
    t0 = time.perf_counter()
    compiled = _persp_jit.lower(
        baked, feats, jnp.asarray(c2w), perm, inv, opt, width, width,
        float(fx), float(fx)).compile()
    print(f"[{P}] exact march compile {time.perf_counter() - t0:.2f} s; "
          f"memory_analysis: {compiled.memory_analysis()}", flush=True)

    img, first, warm = timed(lambda: r.render_persp(feats, c2w, width,
                                                    width, fx))
    rep.timing(P, f"exact render_persp {width}x{width}", first, warm)
    rep.require(P, "exact image finite, shape "
                f"{tuple(img.shape)}", bool(np.isfinite(np.asarray(img)).all())
                and img.shape == (width, width, 4))

    fast, first, warm = timed(lambda: r.render_persp(feats, c2w, width,
                                                     width, fx, fast=True))
    rep.timing(P, "fast render_persp", first, warm)
    rep.check(P, "fast vs exact image", max_abs(fast, img), "fast_vs_exact")

    # Oracle on sampled pixels: the same rays feed the production
    # forward and the scan oracle; the render_persp image (which makes
    # its own rays inside its program) is compared too.
    o, d = _camera_rays(jnp.asarray(c2w), width, float(fx))
    rng = np.random.RandomState(seed)
    sel = jnp.asarray(rng.choice(width * width, min(n_check, width * width),
                                 replace=False))
    rays = st.Rays(o[sel], d[sel], d[sel])
    t0 = time.perf_counter()
    ref = jax.block_until_ready(jax.jit(
        volume_render_oracle, static_argnames=("opt",))(
        tree._spec(), feats, rays.origins, rays.dirs, rays.viewdirs,
        opt=opt))
    print(f"[{P}] oracle on {sel.shape[0]} rays: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    got = r(feats, rays)
    rep.check(P, f"forward vs oracle, {sel.shape[0]} sampled rays",
              max_abs(got, ref), "oracle_fwd")
    rep.check(P, f"render_persp vs oracle, {sel.shape[0]} sampled pixels",
              max_abs(np.asarray(img).reshape(-1, 4)[np.asarray(sel)], ref),
              "oracle_fwd")

    # Reduced-precision pools: compared with the f32 render of the very
    # same (rounded / dequantized) values.
    fb = feats.astype(jnp.bfloat16)
    img_b, first, warm = timed(lambda: r.render_persp(fb, c2w, width, width,
                                                      fx))
    rep.timing(P, "bf16-pool render_persp", first, warm)
    ref_b = r.render_persp(fb.astype(jnp.float32), c2w, width, width, fx)
    rep.check(P, "bf16 pool vs f32 render of the bf16 values",
              max_abs(img_b, ref_b), "quant_vs_dequant")
    print(f"[{P}] bf16 rounding error vs the f32 image (information): "
          f"{max_abs(img_b, img):.3e}", flush=True)

    qf = st.quantize_features(feats)
    img_q, first, warm = timed(lambda: r.render_persp(qf, c2w, width, width,
                                                      fx))
    rep.timing(P, "int8-pool render_persp", first, warm)
    deq = qf.q.astype(jnp.float32) * qf.scale + qf.zero
    ref_q = r.render_persp(deq, c2w, width, width, fx)
    rep.check(P, "int8 pool vs f32 render of the dequantized values",
              max_abs(img_q, ref_q), "quant_vs_dequant")
    print(f"[{P}] int8 quantization error vs the f32 image (information): "
          f"{max_abs(img_q, img):.3e}", flush=True)
    rep.memory(P)


# ---------------------------------------------------------------------------
# P2: training
# ---------------------------------------------------------------------------


def phase_train(rep: Report, depth=7, width=800, n_check=4096,
                n_adam=3, mb_rays=65536, mb_steps=4, seed=0):
    import jax
    import jax.numpy as jnp
    import optax

    import svox_t_tpu as st
    from benchmarks.scenes import build_shell_tree, orbit_camera
    from svox_t_tpu.ops import tape as tape_ops
    from svox_t_tpu.ops import tape_subset as tsub
    from svox_t_tpu.ops.reference_renderer import volume_render_oracle

    P = "P2"
    tree, feats = build_shell_tree(depth=depth, data_format="SH9",
                                   data_dim=28)
    r = st.VolumeRenderer(tree, step_size=1e-3)
    opt = r._get_options(False)
    c2w = orbit_camera()
    fx = width * 1.1
    o, d = _camera_rays(jnp.asarray(c2w), width, float(fx))
    rays = st.Rays(o, d, d)
    rng = np.random.RandomState(seed)
    noise = jnp.asarray(rng.randn(*feats.shape).astype(np.float32) * 0.05)
    target = r(feats + noise, rays)
    f0 = feats * 0.9

    # Eager jax.grad: the renderer's own jitted programs take the scene
    # as arguments (an outer jit would bake it in as constants).
    loss_fn = lambda f: _l2(r(f, rays), target)  # noqa: E731
    grad_fn = jax.grad(loss_fn)
    g1, first, warm = timed(lambda: grad_fn(f0))
    rep.timing(P, f"jax.grad through VolumeRenderer on {o.shape[0]} rays",
               first, warm)
    g2 = grad_fn(f0)
    g1n, g2n = np.asarray(g1), np.asarray(g2)
    same = bool(np.array_equal(g1n, g2n))
    print(f"[{P}] determinism: two runs of the same gradient are "
          f"{'bitwise equal' if same else 'NOT bitwise equal'}; largest "
          f"difference {np.max(np.abs(g1n - g2n)):.3e} (largest entry "
          f"{np.max(np.abs(g1n)):.3e})", flush=True)
    rep.require(P, "gradient finite", bool(np.isfinite(g1n).all()))

    sel = jnp.asarray(rng.choice(o.shape[0], min(n_check, o.shape[0]),
                                 replace=False))
    sub = st.Rays(o[sel], d[sel], d[sel])
    tsub_ = target[sel]
    g_sub = jax.grad(lambda f: _l2(r(f, sub), tsub_))(f0)
    oracle = jax.jit(volume_render_oracle, static_argnames=("opt",))
    spec = tree._spec()
    g_or = jax.grad(lambda f: _l2(oracle(spec, f, sub.origins, sub.dirs,
                                         sub.viewdirs, opt=opt), tsub_))(f0)
    rep.check(P, f"gradient vs oracle gradient, {sel.shape[0]} rays",
              max_abs(g_sub, g_or), "grad_oracle",
              scale=np.max(np.abs(np.asarray(g_or))))

    adam = optax.adam(1e-2)

    @jax.jit
    def adam_update(f, g, s):
        upd, s = adam.update(g, s, f)
        return optax.apply_updates(f, upd), s

    f, s = f0, adam.init(f0)
    losses = []
    t0 = time.perf_counter()
    for _ in range(n_adam):
        loss, g = jax.value_and_grad(loss_fn)(f)
        f, s = adam_update(f, g, s)
        losses.append(float(loss))
    print(f"[{P}] smoke timing on {rep.card}: {n_adam} Adam steps "
          f"(first compiles) {time.perf_counter() - t0:.3f} s; losses "
          f"{losses}", flush=True)
    rep.require(P, "Adam losses finite and decreasing",
                bool(np.isfinite(losses).all() and losses[-1] < losses[0]))

    # Random-ray minibatches over a 4-view rig tape.
    c2ws = np.stack([orbit_camera(theta=0.9 * v, phi=0.3 + 0.1 * v)
                     for v in range(4)])
    rig = r.record_persp_rig(c2ws, width, width, fx=fx, features=feats,
                             group_size=1)
    src = tsub.TapeRowSource(rig)
    tgt = tape_ops.replay_render(rig, feats, opt)[:, :3]
    ids = rng.randint(0, rig.n_rays, size=(mb_steps, mb_rays))
    pack = tsub.prep_minibatches(src, ids, chunk_size=256)

    def run_mb():
        return tsub.train_minibatches(src, pack, tgt, f0, opt, lr=0.05)

    (f_mb, mb_losses, _), first, warm = timed(run_mb)
    rep.timing(P, f"train_minibatches, {mb_steps} steps of {mb_rays} rays",
               first, warm)
    mb_losses = np.asarray(mb_losses)
    # Each step draws other rays, so the losses need not fall.
    rep.require(P, f"minibatch losses {mb_losses} and features finite",
                bool(np.isfinite(mb_losses).all()
                     and np.isfinite(np.asarray(f_mb)).all()))
    # Step 0 loss against the march on the same rays (rig rays in
    # (view, pixel) order; zero-occupancy rays contribute exactly 0).
    rig_rays = [_camera_rays(jnp.asarray(c), width, float(fx)) for c in c2ws]
    ro = jnp.concatenate([x[0] for x in rig_rays])[ids[0]]
    rd = jnp.concatenate([x[1] for x in rig_rays])[ids[0]]
    out0 = r(f0, st.Rays(ro, rd, rd))[:, :3]
    ref0 = float(jnp.sum((out0 - tgt[ids[0]]) ** 2)) / (mb_rays * 3)
    rep.check(P, "minibatch step-0 loss vs march loss on the same rays",
              abs(float(mb_losses[0]) - ref0), "minibatch_loss",
              scale=abs(ref0))
    rep.memory(P)


# ---------------------------------------------------------------------------
# P3: recorded tapes
# ---------------------------------------------------------------------------


def phase_tape(rep: Report, depth=7, width=800, n_frames=4):
    import jax
    import jax.numpy as jnp

    import svox_t_tpu as st
    from benchmarks.scenes import build_shell_tree, orbit_camera

    P = "P3"
    tree, feats = build_shell_tree(depth=depth, data_format="SH9",
                                   data_dim=28)
    r = st.VolumeRenderer(tree, step_size=1e-3)
    c2w = orbit_camera()
    fx = width * 1.1

    t0 = time.perf_counter()
    tape = r.record_persp(c2w, width, width, fx=fx, features=feats)
    jax.block_until_ready(tape.idx)
    print(f"[{P}] record_persp (cold, with compilation) "
          f"{time.perf_counter() - t0:.3f} s on {rep.card}", flush=True)
    img_t, first, warm = timed(lambda: r.render_persp_tape(
        feats, c2w, width, width, fx))
    rep.timing(P, "render_persp_tape", first, warm)
    img = r.render_persp(feats, c2w, width, width, fx)
    rep.check(P, "render_persp_tape vs render_persp", max_abs(img_t, img),
              "tape_vs_march")

    scales = 1.0 + 0.05 * jnp.arange(n_frames, dtype=jnp.float32)
    stack = feats[None] * scales[:, None, None]
    frames, first, warm = timed(lambda: r.render_tape_frames(tape, stack))
    rep.timing(P, f"render_tape_frames x{n_frames}", first, warm)
    dev = max(max_abs(frames[i].reshape(width, width, -1),
                      r.render_persp(stack[i], c2w, width, width, fx))
              for i in range(n_frames))
    rep.check(P, f"render_tape_frames vs render_persp, {n_frames} frames",
              dev, "tape_vs_march")

    # Gradients on identical rays: tape VJP vs march VJP.
    o, d = _camera_rays(jnp.asarray(c2w), width, float(fx))
    rays = st.Rays(o, d, d)
    tape_r = r.record_rays(rays, features=feats)
    target = jnp.full((o.shape[0], 4), 0.5, jnp.float32)
    f0 = feats * 0.9
    g_tape, first, warm = timed(lambda: jax.grad(
        lambda f: _l2(r.render_tape(tape_r, f), target))(f0))
    rep.timing(P, "tape fwd+bwd gradient", first, warm)
    g_march = jax.grad(lambda f: _l2(r(f, rays), target))(f0)
    rep.check(P, "tape gradient vs march gradient", max_abs(g_tape, g_march),
              "tape_grad", scale=np.max(np.abs(np.asarray(g_march))))
    rep.memory(P)


# ---------------------------------------------------------------------------
# P4: animation (Artemis outputs)
# ---------------------------------------------------------------------------


def lbs_scene(n_points=20000, depth=6, n_frames=4, seed=1):
    """The 2-bone LBS benchmark scene: a Gaussian point cloud, RGBA
    features, skinning weights blending a fixed and a z-rotating bone."""
    import jax.numpy as jnp

    import svox_t_tpu as st

    rng = np.random.RandomState(seed)
    pts = np.clip(0.5 + 0.15 * rng.randn(n_points, 3), 0.2, 0.8
                  ).astype(np.float32)
    feats = jnp.asarray(np.concatenate(
        [rng.rand(n_points, 3), 8.0 + rng.rand(n_points, 1)], axis=1
    ).astype(np.float32))
    sw = np.stack([1.0 - pts[:, 2], pts[:, 2]], axis=1).astype(np.float32)
    ji = np.tile(np.array([0, 1], np.int32), (n_points, 1))
    tree = st.N3Tree(N=2, data_dim=4, depth_limit=depth)
    tree.refine(repeats=depth - 1)
    tree.construct_tree(jnp.asarray(pts))
    tree.features = feats
    poses = []
    for i in range(n_frames):
        a = 0.5 * np.sin(2 * np.pi * i / n_frames)
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0],
                        [0, 0, 0, 1]], np.float32)
        poses.append(np.stack([np.eye(4, dtype=np.float32), rot]))
    src = np.stack([np.eye(4, dtype=np.float32)] * 2)
    return tree, feats, pts, sw, ji, np.stack(poses), src


def phase_animation(rep: Report, n_points=20000, depth=6, width=800,
                    n_frames=4):
    import jax
    import jax.numpy as jnp

    import svox_t_tpu as st
    from benchmarks.scenes import orbit_camera

    P = "P4"
    tree, feats, pts, sw, ji, poses, src = lbs_scene(n_points, depth,
                                                    n_frames)
    r = st.VolumeRenderer(tree)
    c2w = orbit_camera()
    fx = width * 1.1
    args = (feats, poses, src, pts, sw, ji)
    kw = dict(c2w=c2w, width=width, height=width, fx=fx, update_tree=False)

    (cols, depths), first, warm = timed(lambda: r.render_dynamic_frames(
        *args, with_depth=True, **kw))
    rep.timing(P, f"render_dynamic_frames x{n_frames} (+depth)", first, warm)
    rep.require(P, f"dynamic frames finite, shape {tuple(cols.shape)}",
                bool(np.isfinite(np.asarray(cols)).all())
                and cols.shape == (n_frames, width, width, 4))

    t0 = time.perf_counter()
    tape = r.record_dynamic_persp(c2w, poses, src, pts, sw, ji, width, width,
                                  fx=fx, record_t=True)
    jax.block_until_ready(tape.idx)
    print(f"[{P}] record_dynamic_persp (cold, with compilation) "
          f"{time.perf_counter() - t0:.3f} s on {rep.card}", flush=True)
    (cols_t, depths_t), first, warm = timed(
        lambda: r.render_dynamic_tape_frames(*args, tape=tape,
                                             with_depth=True, **kw))
    rep.timing(P, f"render_dynamic_tape_frames x{n_frames} (+depth)", first,
               warm)
    rep.check(P, "dynamic tape colours vs fused loop", max_abs(cols_t, cols),
              "tape_vs_march")
    rep.check(P, "dynamic tape depth vs fused loop", max_abs(depths_t, depths),
              "tape_vs_march")

    # Frame 0 the eager way: re-point the tree, then the Artemis passes.
    T = st.get_transformation_matrix(jnp.asarray(src), jnp.asarray(poses[0]))
    warped, _ = st.warp_vertices(T, jnp.asarray(pts), jnp.asarray(sw),
                                 jnp.asarray(ji))
    tree.construct_tree(warped)
    o, d = _camera_rays(jnp.asarray(c2w), width, float(fx))
    rays = st.Rays(o, d, d)
    dep, first, warm = timed(lambda: r.render_depth(feats, rays))
    rep.timing(P, "render_depth, one frame", first, warm)
    op, first, warm = timed(lambda: r.opacity_render(feats, rays))
    rep.timing(P, "opacity_render, one frame", first, warm)
    rgba = r(feats, rays)
    rep.check(P, "opacity_render vs forward alpha", max_abs(op[:, 0],
                                                            rgba[:, 3]),
              "aux_vs_march")
    rep.check(P, "render_depth vs fused-loop depth, frame 0",
              max_abs(dep.reshape(width, width, 1), depths[0]),
              "aux_vs_march")
    rep.memory(P)


# ---------------------------------------------------------------------------
# P5: device trace
# ---------------------------------------------------------------------------


def phase_trace(rep: Report, depth=7, width=800, top=10):
    import svox_t_tpu as st
    from benchmarks.scenes import build_shell_tree, orbit_camera
    from svox_t_tpu.utils.profiling import device_trace

    P = "P5"
    tree, feats = build_shell_tree(depth=depth, data_format="SH9",
                                   data_dim=28)
    r = st.VolumeRenderer(tree, step_size=1e-3)
    c2w = orbit_camera()
    fx = width * 1.1
    r.render_persp(feats, c2w, width, width, fx).block_until_ready()
    with tempfile.TemporaryDirectory() as td:
        with device_trace(td) as t:
            r.render_persp(feats, c2w, width, width, fx).block_until_ready()
        res = t.result
    print(f"[{P}] trace threads: {res.threads[:8]}", flush=True)
    print(f"[{P}] one warm {width}x{width} exact march frame on {rep.card}: "
          f"device busy {res.busy_ms:.3f} ms of a {res.window_ms:.3f} ms "
          f"window, busy share {res.busy_share:.4f}, idle share "
          f"{res.idle_share:.4f}", flush=True)
    for nm, ms, c in res.top(top):
        print(f"[{P}]   {ms:9.3f} ms  x{c:<6d} {nm[:90]}", flush=True)
    rep.require(P, "device op table non-empty", len(res.top(top)) > 0)


# ---------------------------------------------------------------------------
# --multi: four GPUs
# ---------------------------------------------------------------------------


def phase_multi(rep: Report, devices, depth_dp=7, depth_pool=9, width=800):
    """Sharded steps on four devices, each compared with one device."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as Ps

    import svox_t_tpu as st
    from benchmarks.scenes import build_shell_tree, orbit_camera
    from svox_t_tpu.ops.render import volume_render
    from svox_t_tpu.parallel import (make_pool_train_step, make_ray_mesh,
                                     render_pool_sharded, shard_baked,
                                     shard_rays)

    P = "MULTI"
    assert len(devices) == 4, f"need 4 devices, have {len(devices)}"
    c2w = orbit_camera()
    fx = width * 1.1

    def rays_on(dev):
        with jax.default_device(dev):
            o, d = _camera_rays(jnp.asarray(c2w), width, float(fx))
        return st.Rays(o, d, d)

    # 1. Ray data parallelism, depth-7 scene.
    tree, feats = build_shell_tree(depth=depth_dp, data_format="SH9",
                                   data_dim=28)
    r = st.VolumeRenderer(tree, step_size=1e-3)
    opt = r._get_options(False)
    rays = rays_on(devices[0])
    target = jnp.full((rays.origins.shape[0], 4), 0.5, jnp.float32)

    baked = tree._baked_spec()
    (f4, _), first, warm = _sgd_step(make_ray_mesh(devices), opt, feats,
                                     baked, rays, target)
    rep.timing(P, f"make_train_step on 4 devices, {width}x{width} rays",
               first, warm)
    (f1, _), _, warm1 = _sgd_step(make_ray_mesh(devices[:1]), opt, feats,
                                  baked, rays, target)
    print(f"[{P}] same step on 1 device: warm {warm1 * 1e3:.3f} ms",
          flush=True)
    g_scale = np.max(np.abs(np.asarray(f1) - np.asarray(feats)))
    rep.require(P, "one-device update is non-zero", g_scale > 0)
    rep.check(P, "ray-DP SGD update vs one device", max_abs(f4, f1), "multi",
              scale=g_scale)

    # 2. 2x2 (rays, pool) mesh with the depth-9 pool row-sharded.
    tree9, feats9 = build_shell_tree(depth=depth_pool, data_format="SH9",
                                     data_dim=28)
    r9 = st.VolumeRenderer(tree9, step_size=1e-3)
    opt9 = r9._get_options(False)
    baked9 = tree9._baked_spec()
    M = feats9.shape[0]
    mesh2 = Mesh(np.asarray(devices).reshape(2, 2), ("rays", "pool"))
    step2 = make_pool_train_step(mesh2, opt9, n_features=M,
                                 optimizer=optax.sgd(1.0))
    state2 = step2.init(feats9)
    rs2 = shard_rays(mesh2, rays)
    tgt2 = jax.device_put(target, NamedSharding(mesh2, Ps("rays")))
    ((fp, _), _), first, warm = timed(
        lambda: step2(state2, baked9, tuple(rs2), tgt2))
    rep.timing(P, f"make_pool_train_step on a 2x2 mesh, depth-{depth_pool} "
               "pool row-sharded", first, warm)
    (fs, _), _, warm1 = _sgd_step(make_ray_mesh(devices[:1]), opt9, feats9,
                                  baked9, rays, target)
    print(f"[{P}] same step on 1 device: warm {warm1 * 1e3:.3f} ms",
          flush=True)
    fp_host = np.asarray(jax.device_get(fp))[:M]
    g_scale9 = np.max(np.abs(np.asarray(fs) - np.asarray(feats9)))
    rep.require(P, "one-device update is non-zero", g_scale9 > 0)
    rep.check(P, "pool-sharded SGD update vs one device", max_abs(fp_host, fs),
              "multi", scale=g_scale9)

    # 3. Brick atlas sharded over 4 devices: forward only.
    mesh4 = Mesh(np.asarray(devices), ("pool",))
    baked_s = shard_baked(mesh4, baked9)
    out_s, first, warm = timed(lambda: render_pool_sharded(
        mesh4, baked_s, feats9, rays, opt9))
    rep.timing(P, f"shard_baked forward, depth-{depth_pool}, 4 devices",
               first, warm)
    with jax.default_device(devices[0]):
        ref = volume_render(baked9, feats9, rays.origins, rays.dirs,
                            rays.viewdirs, opt9)
    rep.check(P, "shard_baked forward vs one device", max_abs(out_s, ref),
              "multi", scale=1.0)
    for dv in devices:
        rep.memory(P, dv)


def _sgd_step(mesh, opt, feats, spec, rays, target):
    """One ray-sharded `make_train_step` SGD(1.0) step on ``mesh``:
    ((features, opt_state), first_s, warm_s) — the loss is dropped."""
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as Ps

    from svox_t_tpu.parallel import make_train_step, replicate_spec, shard_rays

    step = make_train_step(mesh, opt, optimizer=optax.sgd(1.0))
    state = step.init(feats)
    spec = replicate_spec(mesh, spec)
    rs = shard_rays(mesh, rays)
    tgt = jax.device_put(target, NamedSharding(mesh, Ps("rays")))
    (state, _), first, warm = timed(lambda: step(state, spec, tuple(rs), tgt))
    return state, first, warm


# ---------------------------------------------------------------------------


def card_name() -> str:
    """``name, power limit`` of every card, as nvidia-smi reports them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded steps")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r}); "
              "refusing to fall back", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from svox_t_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    smi = card_name()
    print(f"[P0] nvidia-smi name, power.limit: {smi}", flush=True)
    print(f"[P0] JAX {jax.__version__}: {len(devs)} x {devs[0].device_kind}; "
          f"compile cache {cache}", flush=True)
    rep = Report(card=smi.splitlines()[0])

    if args.multi:
        phases = [("MULTI", lambda: phase_multi(rep, devs[:4]))]
    else:
        phases = [
            ("P1", lambda: phase_static(rep)),
            ("P2", lambda: phase_train(rep)),
            ("P3", lambda: phase_tape(rep)),
            ("P4", lambda: phase_animation(rep)),
            ("P5", lambda: phase_trace(rep)),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # recorded; the run exits non-zero below
            traceback.print_exc()
            rep.failures.append(f"{name}: raised")
        print(f"[{name}] phase wall time {time.perf_counter() - t0:.1f} s",
              flush=True)

    if rep.failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(rep.failures),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
