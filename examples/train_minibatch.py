#!/usr/bin/env python
"""Random-pixel minibatch training through row-subset tapes — the
canonical NeRF/Artemis training loop (reference workflow: sample random
rays across the training cameras each step and call the renderer on the
fresh batch, svox_t/renderer.py:207-308).

The shape of that loop here (ops/tape_subset.py):

  1. `record_persp_rig` records ONE tape over all training cameras
     (the structure walk is per-(rig x structure), paid once);
  2. `TapeRowSource` re-lays it ray-major into one packed matrix, so an
     arbitrary ray subset is a single in-graph row gather;
  3. `prep_minibatches` (host-only) sorts/chunks the next N batches
     while the device executes the current N — input-pipeline prefetch;
  4. `train_minibatches` runs N sequential SGD steps per dispatch:
     per step, subset gather -> replay fwd -> tape VJP (bulk flush) ->
     in-dispatch update. Step n+1 sees step n's update.

Gradients equal the march's on the identical rays (tests/
test_tape_subset.py).

    python examples/train_minibatch.py [n_superbatches]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import svox_t_tpu as st
from svox_t_tpu.utils.compile_cache import enable_compile_cache


def build_scene(rng):
    t = st.N3Tree(N=2, data_dim=28, depth_limit=5, data_format="SH9")
    t.refine(repeats=3)
    centers = np.asarray(jax.device_get(t.tree2world(jnp.asarray(
        t[:].corners_local + 0.5 * t[:].lengths_local[:, None]))))
    t.construct_tree(centers)
    f = rng.randn(centers.shape[0], 28).astype(np.float32)
    f[:, -1] = np.abs(f[:, -1]) * 5
    return t, jnp.asarray(f)


def main():
    enable_compile_cache()
    n_super = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    rng = np.random.RandomState(0)
    tree, f_true = build_scene(rng)
    r = st.VolumeRenderer(tree)

    # Training cameras: a 4-view rig; ONE tape covers them all.
    c2ws = []
    for v in range(4):
        th = 0.6 + 1.2 * v
        eye = 0.5 + 2.2 * np.array(
            [np.cos(th) * 0.9, np.sin(th) * 0.9, 0.45])
        fwd = 0.5 - eye
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        m = np.eye(4, dtype=np.float32)
        m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, -fwd, eye
        c2ws.append(m)
    c2ws = np.stack(c2ws)
    W = H = 128
    tape = r.record_persp_rig(c2ws, W, H, fx=W * 1.1, features=f_true,
                              group_size=1)
    src = st.TapeRowSource(tape)
    opt = r._get_options(False)

    # Ground-truth target images via one replay of the true features.
    targets = st.replay_render(tape, f_true, opt)[:, :3]

    N, B = 8, 8192
    f = f_true * 0.7 + 0.05  # perturbed start

    # Adam through the update_fn hook (state threads through the
    # in-dispatch scan) — per-parameter step sizes fix the scale
    # mismatch between dense pool rows and sparse minibatch touches.
    def adam(lr=3e-2, b1=0.9, b2=0.999, eps=1e-8):
        def update(ff, g, state):
            m, v, step = state
            step = step + 1.0
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / (1 - b1 ** step)
            vh = v / (1 - b2 ** step)
            return ff - lr * mh / (jnp.sqrt(vh) + eps), (m, v, step)
        return update

    upd = adam()
    state = (jnp.zeros_like(f), jnp.zeros_like(f), jnp.zeros(()))
    pack = st.ops.tape_subset.prep_minibatches(
        src, rng.randint(0, tape.n_rays, size=(N, B)))
    for s in range(n_super):
        f, losses, state = st.train_minibatches(
            src, pack, targets, f, opt, update_fn=upd,
            update_state=state,
        )
        # prep the NEXT super-batch while the device runs this one
        pack = st.ops.tape_subset.prep_minibatches(
            src, rng.randint(0, tape.n_rays, size=(N, B)))
        print(f"super-batch {s}: losses "
              f"{np.asarray(losses).round(6).tolist()}")
    # Image-space error (the honest metric: the fit is underdetermined
    # in parameter space — many pools render the same images).
    out = st.replay_render(tape, f, opt)[:, :3]
    out0 = st.replay_render(tape, f_true * 0.7 + 0.05, opt)[:, :3]
    err = float(jnp.mean(jnp.abs(out - targets)))
    err0 = float(jnp.mean(jnp.abs(out0 - targets)))
    print(f"final mean image |err| = {err:.5f} (start was {err0:.5f})")


if __name__ == "__main__":
    main()
