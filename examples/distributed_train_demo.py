#!/usr/bin/env python
"""Multi-chip training-step demo on a virtual 8-device CPU mesh
(`XLA_FLAGS=--xla_force_host_platform_device_count=8`): rays sharded
data-parallel, tree + feature pool replicated, feature-grad all-reduce
inserted by GSPMD. The same code drives the GPUs of one host (drop the
two CPU lines below); for multi-HOST runs call
`svox_t_tpu.parallel.initialize(...)` first (see parallel/distributed.py).

    python examples/distributed_train_demo.py [n_steps]
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import svox_t_tpu as st
from svox_t_tpu.utils.compile_cache import enable_compile_cache
from svox_t_tpu.parallel import (make_ray_mesh, make_train_step,
                                 replicate_spec, shard_rays)


def main():
    enable_compile_cache()
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    rng = np.random.RandomState(0)

    tree = st.N3Tree(N=2, data_dim=4, depth_limit=5)
    tree.refine(repeats=3)
    centers = np.asarray(jax.device_get(tree.tree2world(jnp.asarray(
        tree[:].corners_local + 0.5 * tree[:].lengths_local[:, None]))))
    tree.construct_tree(centers)
    M = centers.shape[0]
    target_feats = np.concatenate(
        [rng.rand(M, 3), 5 + 3 * rng.rand(M, 1)], axis=1
    ).astype(np.float32)

    mesh = make_ray_mesh()
    print(f"mesh: {mesh.shape} over {len(jax.devices())} devices")
    spec = replicate_spec(mesh, tree)
    opt = st.VolumeRenderer(tree)._get_options(False)

    B = 1024
    phi = rng.rand(B) * 2 * np.pi
    costh = rng.rand(B) * 2 - 1
    sinth = np.sqrt(1 - costh ** 2)
    o = (0.5 + 2.0 * np.stack(
        [sinth * np.cos(phi), sinth * np.sin(phi), costh], -1
    )).astype(np.float32)
    tg = 0.5 + (rng.rand(B, 3) - 0.5) * 1.1
    d = tg - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = shard_rays(mesh, st.Rays(o, d, d))

    # Target images rendered from the "ground-truth" features.
    from svox_t_tpu.ops.render import volume_render
    target = volume_render(
        spec, jnp.asarray(target_feats), rays.origins, rays.dirs,
        rays.viewdirs, opt,
    )

    import optax
    step = make_train_step(mesh, opt, optimizer=optax.adam(5e-2))
    # Init with small positive densities: sigma == 0 is the contribution
    # gate (matching the reference), so an all-zero init has no gradient.
    init_feats = np.concatenate(
        [0.1 * rng.randn(M, 3), 0.5 + 0.1 * rng.rand(M, 1)], axis=1
    ).astype(np.float32)
    state = step.init(jnp.asarray(init_feats))
    for i in range(n_steps):
        state, loss = step(
            state, spec, (rays.origins, rays.dirs, rays.viewdirs), target
        )
        if i % 5 == 0 or i == n_steps - 1:
            print(f"step {i:3d}: loss {float(loss):.6f}", flush=True)

    # --- 2-D DP x MP: rays sharded x feature pool ROW-sharded ----------
    # For scenes whose pool + optimizer state outgrow one chip's HBM:
    # each chip stores 1/n_pool of the rows; one psum per march round
    # assembles gathered rows (see parallel/render.py).
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from svox_t_tpu.parallel import make_pool_train_step

    mesh2 = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("rays", "pool"))
    rays2 = shard_rays(mesh2, st.Rays(rays.origins, rays.dirs, rays.viewdirs))
    target2 = jax.device_put(target, NamedSharding(mesh2, P("rays")))
    step2 = make_pool_train_step(
        mesh2, opt, n_features=M, optimizer=optax.adam(5e-2)
    )
    state2 = step2.init(jnp.asarray(init_feats))
    print("pool shard sharding:", state2[0].sharding.spec)
    for i in range(n_steps):
        state2, loss = step2(
            state2, tree._spec(),
            (rays2.origins, rays2.dirs, rays2.viewdirs), target2,
        )
        if i % 5 == 0 or i == n_steps - 1:
            print(f"2-D step {i:3d}: loss {float(loss):.6f}", flush=True)


if __name__ == "__main__":
    main()
