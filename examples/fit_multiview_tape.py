#!/usr/bin/env python
"""Multi-view feature fitting through ONE recorded rig tape — the
Artemis fitting regime (a fixed capture rig around a volume whose
features are optimized; reference workflow: per-view renders through
`VolumeRenderer.forward`, renderer.py:207).

The shape of that loop here:

  1. `record_persp_rig` records a single tape over ALL V cameras
     (the structure walk is per-(rig x structure), paid once),
  2. targets are converted to TAPE order once, outside the loop,
  3. every SGD step is one dispatch: replay fwd (radiometry only)
     + the single-pass tape VJP + one bulk gradient flush.

No structure walk runs inside the fitting loop: every step replays
recorded samples instead of re-marching the octree.

    python examples/fit_multiview_tape.py [n_steps]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import svox_t_tpu as st
from svox_t_tpu.utils.compile_cache import enable_compile_cache
from svox_t_tpu.ops import tape as tape_ops


def look_at(eye):
    """c2w looking from `eye` at the volume center (0.5, 0.5, 0.5)."""
    eye = np.asarray(eye, np.float32)
    fwd = (np.array([0.5, 0.5, 0.5], np.float32) - eye)
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    # svox camera convention: x right, y down, z into the scene (-z cam)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, -up, -fwd, eye
    return c2w


def main(n_steps=60):
    enable_compile_cache()
    rng = np.random.RandomState(0)
    t = st.N3Tree(N=2, data_dim=4, data_format="RGBA", depth_limit=4)
    t.refine(repeats=3)
    centers = np.asarray(jax.device_get(t.tree2world(jnp.asarray(
        t[:].corners_local + 0.5 * t[:].lengths_local[:, None]))))
    # occupy a shell so the scene has silhouettes to fit
    r_c = np.linalg.norm(centers - 0.5, axis=-1)
    centers = centers[(r_c > 0.2) & (r_c < 0.45)]
    t.construct_tree(centers)
    M = centers.shape[0]

    feats_true = rng.rand(M, 4).astype(np.float32)
    feats_true[:, -1] = 8.0 + 20.0 * feats_true[:, -1]
    feats_true = jnp.asarray(feats_true)

    r = st.VolumeRenderer(t, step_size=0.01, chunk_size=256)
    W, H = 48, 32
    c2ws = np.stack([
        look_at([0.5 + 1.8 * np.cos(a), 0.9, 0.5 + 1.8 * np.sin(a)])
        for a in (0.3, 2.1, 4.2, 5.5)
    ])

    # ONE tape for the whole 4-view rig; targets in tape order (the hot
    # loop never pays an output unsort — the documented training shape).
    tape = r.record_persp_rig(c2ws, W, H, fx=40.0, features=feats_true,
                              group_size=1)
    opt = r._get_options(False)
    spec = r._render_spec()
    target = tape_ops.replay_render(tape, feats_true, opt, spec,
                                    unsort=False)

    import optax

    optimizer = optax.adam(
        optax.cosine_decay_schedule(5e-2, max(n_steps, 1))
    )
    feats = jnp.full((M, 4), 0.5, jnp.float32)
    ostate = optimizer.init(feats)

    @jax.jit
    def step(f, os_):
        def loss_of(ff):
            pred = tape_ops.replay_render(tape, ff, opt, spec,
                                          unsort=False)
            return 0.5 * jnp.mean((pred - target) ** 2)

        loss, g = jax.value_and_grad(loss_of)(f)
        up, os_ = optimizer.update(g, os_, f)
        return optax.apply_updates(f, up), os_, loss

    for i in range(n_steps):
        feats, ostate, loss = step(feats, ostate)
        if i % 10 == 0 or i == n_steps - 1:
            print(f"step {i:3d}  loss {float(loss):.6f}")

    # the fitted volume, rendered for every rig view in one dispatch
    imgs = r.render_persp_rig_tape(feats, c2ws, W, H, fx=40.0)
    ref = r.render_persp_rig_tape(feats_true, c2ws, W, H, fx=40.0)
    psnr = -10 * np.log10(float(jnp.mean((imgs - ref) ** 2)) + 1e-12)
    print(f"rig render {tuple(imgs.shape)}  PSNR vs ground truth "
          f"{psnr:.1f} dB")
    assert psnr > 20.0, "fit did not converge"


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 150)
