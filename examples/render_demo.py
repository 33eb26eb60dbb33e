#!/usr/bin/env python
"""Minimal end-to-end demo: build a procedural scene, render a turntable
of frames with color + opacity + depth, and write them as PPM images.

    python examples/render_demo.py [out_dir]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

import svox_t_tpu as st
from svox_t_tpu.utils.compile_cache import enable_compile_cache
from benchmarks.scenes import build_shell_tree, orbit_camera


def write_ppm(path, img):
    """img: (H, W, 3) float in [0, 1]."""
    arr = np.clip(np.asarray(img) * 255, 0, 255).astype(np.uint8)
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def main():
    enable_compile_cache()
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/svox_t_tpu_demo"
    os.makedirs(out_dir, exist_ok=True)

    tree, feats = build_shell_tree(depth=6, data_format="SH9", data_dim=28)
    r = st.VolumeRenderer(tree, background_brightness=1.0)
    W = 256

    for i, theta in enumerate(np.linspace(0, 2 * np.pi, 4, endpoint=False)):
        c2w = orbit_camera(theta, 0.35)
        t0 = time.time()
        img = r.render_persp(feats, c2w, width=W, height=W, fx=W * 1.1)
        img = np.asarray(img)
        print(f"frame {i}: {1e3 * (time.time() - t0):.0f} ms, "
              f"alpha mean {img[..., -1].mean():.3f}")
        write_ppm(os.path.join(out_dir, f"color_{i}.ppm"), img[..., :3])

        origins, dirs = st.ops.render.cam2world_rays(c2w, W, W, W * 1.1, W * 1.1)
        rays = st.Rays(origins, dirs, dirs)
        op = np.asarray(r.opacity_render(feats, rays)).reshape(W, W)
        dp = np.asarray(r.render_depth(feats, rays)).reshape(W, W)
        write_ppm(os.path.join(out_dir, f"opacity_{i}.ppm"),
                  np.repeat(op[..., None], 3, -1))
        dmax = dp.max() if dp.max() > 0 else 1.0
        write_ppm(os.path.join(out_dir, f"depth_{i}.ppm"),
                  np.repeat((dp / dmax)[..., None], 3, -1))

    # Fixed-camera animated-feature serving through a RECORDED TAPE:
    # the first render_persp_tape call records the structure walk for
    # this camera (cached), then every animation frame replays only
    # radiometry — the steady-state serving path.
    c2w = orbit_camera(0.0, 0.35)
    _ = r.render_persp_tape(feats, c2w, width=W, height=W, fx=W * 1.1)
    for i in range(3):
        anim = feats * (1.0 + 0.2 * np.sin(0.7 * i))
        t0 = time.time()
        img = np.asarray(
            r.render_persp_tape(anim, c2w, width=W, height=W, fx=W * 1.1)
        )
        print(f"tape frame {i}: {1e3 * (time.time() - t0):.0f} ms")
        write_ppm(os.path.join(out_dir, f"tape_{i}.ppm"), img[..., :3])

    print("wrote frames to", out_dir)


if __name__ == "__main__":
    main()
