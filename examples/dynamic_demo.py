#!/usr/bin/env python
"""Dynamic (Artemis-style) per-frame animation loop — the "temporal"
pipeline the svox_t design exists for (SURVEY.md §3.4):

  per frame:
    1. LBS-warp a canonical point cloud with per-joint transforms
       (`get_transformation_matrix` + `warp_vertices`),
    2. re-point the octree at the warped cloud (`construct_tree`,
       on-device; the baked render structure refreshes in one gather),
    3. render color / opacity / depth with this frame's feature matrix,
       with per-voxel view-direction rotation by the blended matrices.

    python examples/dynamic_demo.py [n_frames]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import svox_t_tpu as st
from svox_t_tpu.utils.compile_cache import enable_compile_cache
from benchmarks.scenes import orbit_camera


def make_pose(angle):
    """Two-bone toy skeleton: identity root + a rotation about z."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        np.float32,
    )
    return np.stack([np.eye(4, dtype=np.float32), rot])


def main():
    enable_compile_cache()
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    rng = np.random.RandomState(0)

    # Canonical point cloud: a blob of points around the cube center.
    Q = 4000
    pts = (0.5 + 0.18 * rng.randn(Q, 3)).astype(np.float32)
    pts = np.clip(pts, 0.15, 0.85)
    feats = jnp.asarray(
        np.concatenate(
            [rng.rand(Q, 3), 8.0 + rng.rand(Q, 1)], axis=1
        ).astype(np.float32)
    )
    # Skinning: blend the two bones by height.
    sw = np.stack([1.0 - pts[:, 2], pts[:, 2]], axis=1).astype(np.float32)
    ji = np.tile(np.array([0, 1], np.int32), (Q, 1))

    # Octree refined to cover the cloud's region.
    tree = st.N3Tree(N=2, data_dim=4, depth_limit=6)
    tree.refine(repeats=5)

    renderer = st.VolumeRenderer(tree)
    src_pose = jnp.asarray(make_pose(0.0))
    W = H = 128
    c2w = jnp.asarray(orbit_camera(0.3, 0.4))
    center_dir = jnp.asarray(-np.asarray(c2w)[:3, 2][None])  # camera forward
    origin = jnp.asarray(np.asarray(c2w)[:3, 3][None])

    for i in range(n_frames):
        t0 = time.time()
        tgt_pose = jnp.asarray(make_pose(0.6 * np.sin(2 * np.pi * i / n_frames)))
        T = st.get_transformation_matrix(src_pose, tgt_pose)  # (J, 4, 4)
        warped, per_pt_mats = st.warp_vertices(
            T, jnp.asarray(pts), jnp.asarray(sw), jnp.asarray(ji)
        )
        tree.construct_tree(warped)  # on-device re-point + bake refresh
        img = renderer.render_persp(feats, c2w, W, H, fx=180.0)
        rays_c = st.Rays(origin, center_dir, center_dir)
        opac = renderer.opacity_render(feats, rays_c)
        mean = float(jnp.mean(img[..., -1]))
        print(
            f"frame {i}: warp+repoint+render {1e3*(time.time()-t0):7.1f} ms"
            f"  mean alpha {mean:.4f}  center opacity {float(opac[0,0]):.4f}",
            flush=True,
        )
        assert mean > 0.0, "camera must see the animated blob"

    # Fused variant: the SAME loop as ONE lax.scan dispatch
    # (renderer.render_dynamic_frames) — warp + re-point + bake refresh
    # + render per frame, compiled once; the serving path for animation
    # streams.
    poses = np.stack(
        [
            make_pose(0.6 * np.sin(2 * np.pi * i / n_frames))
            for i in range(n_frames)
        ]
    )
    t0 = time.time()
    outs = renderer.render_dynamic_frames(
        feats, poses, make_pose(0.0), pts, sw, ji,
        c2w=c2w, width=W, height=H, fx=180.0,
    )
    outs.block_until_ready()
    compile_s = time.time() - t0
    t0 = time.time()
    outs = renderer.render_dynamic_frames(
        feats * 1.001, poses, make_pose(0.0), pts, sw, ji,
        c2w=c2w, width=W, height=H, fx=180.0,
    )
    _ = float(jnp.sum(outs))
    fused_s = time.time() - t0
    print(
        f"fused scan: {n_frames} frames in {1e3*fused_s:.1f} ms "
        f"({n_frames/fused_s:.1f} frames/s; first call +compile "
        f"{compile_s:.1f} s)",
        flush=True,
    )


if __name__ == "__main__":
    main()
