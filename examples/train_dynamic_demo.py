#!/usr/bin/env python
"""Train features THROUGH the fused temporal pipeline.

The Artemis training loop optimizes per-frame feature matrices against
multi-view targets while the geometry animates (warp -> re-point ->
render). Here the whole T-frame pipeline is one differentiable scan
(`render_dynamic_frames`), so a training step backprops through every
frame in a single dispatch:

    python examples/train_dynamic_demo.py [n_steps]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
import optax

import svox_t_tpu as st
from svox_t_tpu.utils.compile_cache import enable_compile_cache


def make_pose(angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        np.float32,
    )
    return np.stack([np.eye(4, dtype=np.float32), rot])


def main():
    enable_compile_cache()
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    rng = np.random.RandomState(0)
    T = 4  # frames per step

    Q = 3000
    pts = np.clip(0.5 + 0.15 * rng.randn(Q, 3), 0.2, 0.8).astype(np.float32)
    sw = np.stack([1.0 - pts[:, 2], pts[:, 2]], axis=1).astype(np.float32)
    ji = np.tile(np.array([0, 1], np.int32), (Q, 1))
    tree = st.N3Tree(N=2, data_dim=4, depth_limit=5)
    tree.refine(repeats=4)
    r = st.VolumeRenderer(tree)

    poses = np.stack(
        [make_pose(0.5 * np.sin(2 * np.pi * i / T)) for i in range(T)]
    )
    src = make_pose(0.0)

    # Rays: one small orbit view per frame batch (shared across frames).
    B = 2048
    phi = rng.rand(B) * 2 * np.pi
    costh = rng.rand(B) * 2 - 1
    sinth = np.sqrt(1 - costh ** 2)
    o = 0.5 + 2.0 * np.stack(
        [sinth * np.cos(phi), sinth * np.sin(phi), costh], -1
    )
    d = (0.5 + (rng.rand(B, 3) - 0.5) * 0.6) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = st.Rays(
        jnp.asarray(o.astype(np.float32)),
        jnp.asarray(d.astype(np.float32)),
        jnp.asarray(d.astype(np.float32)),
    )

    # Ground-truth per-frame features; the model starts from noise.
    gt = np.concatenate(
        [rng.rand(Q, 3), 6.0 + rng.rand(Q, 1)], axis=1
    ).astype(np.float32)
    gt_stack = jnp.stack([jnp.asarray(gt) * (1.0 + 0.03 * k) for k in range(T)])
    targets = r.render_dynamic_frames(
        gt_stack, poses, src, pts, sw, ji, rays=rays, update_tree=False
    )
    targets = jax.lax.stop_gradient(targets)

    params = jnp.stack(
        [jnp.asarray(np.concatenate(
            [0.5 * np.ones((Q, 3)), 2.0 * np.ones((Q, 1))], axis=1
        ).astype(np.float32))] * T
    )
    opt = optax.adam(5e-2)
    opt_state = opt.init(params)

    def loss_fn(p):
        outs = r.render_dynamic_frames(
            p, poses, src, pts, sw, ji, rays=rays, update_tree=False
        )
        return jnp.mean((outs - targets) ** 2)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(g, s)
        return optax.apply_updates(p, updates), s, loss

    losses = []
    t0 = time.time()
    for i in range(n_steps):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
        if i in (0, n_steps - 1) or (i + 1) % 5 == 0:
            print(f"step {i:3d}: loss {losses[-1]:.6f}", flush=True)
    dt = time.time() - t0
    print(
        f"{n_steps} steps x {T} frames in {dt:.1f}s "
        f"({n_steps * T / dt:.1f} trained frames/s); "
        f"loss {losses[0]:.5f} -> {losses[-1]:.5f}"
    )
    assert losses[-1] < losses[0] * 0.5, "training must reduce the loss"


if __name__ == "__main__":
    main()
