"""VolumeRenderer — the user-facing differentiable renderer.

API-parity rebuild of the reference `svox_t/renderer.py:162-439`
(`VolumeRenderer` + `Rays`/`NDCConfig` + `convert_to_ndc`), dispatching
to the jitted XLA ops in `ops/render.py` / `ops/render_aux.py` instead of
CUDA launchers. Entry points:

  forward(features, rays, transformation_matrices=None, fast=False)
  render_persp(features, c2w, width, height, fx, fy, fast=False)
  render_frames(features_frames, rays, ...)         (T frames, ONE dispatch)
  render_persp_frames(features_frames, c2w, ...)    (T images, ONE dispatch)
  motion_render(features, rays)                      (non-differentiable)
  render_depth(features, rays)
  motion_feature_render(features, joint_features, skinning_weights,
                        joint_index, rays)           (diff wrt joint feats)
  opacity_render(features, rays)

`fast=True` sets sigma_thresh = stop_thresh = 1e-2; attribute overrides
`self.sigma_thresh` / `self.stop_thresh` are honored, both per the
reference (renderer.py:408-439). One compiled executable is cached per
(options, shapes) combination.
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import render as render_ops
from ..ops import render_aux as aux_ops
from ..ops import tape as tape_ops
from ..utils.dataformat import DataFormat
from ..utils.spec import NDCConfig, Rays, RenderOptions

_TILE_PERM_CACHE = {}


def _tile_perm(width: int, height: int, tile: int):
    """Permutation ordering pixels in (tile x tile) blocks, plus inverse.

    Image renders march rays in chunks; tile-coherent chunks share step
    counts, so each chunk's march loop exits sooner than with row-strip
    chunks."""
    key = (width, height, tile)
    if key not in _TILE_PERM_CACHE:
        iy, ix = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
        ntx = -(-width // tile)
        tid = (iy // tile) * ntx + (ix // tile)
        order = np.lexsort((ix.ravel(), iy.ravel(), tid.ravel()))
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size)
        _TILE_PERM_CACHE[key] = (jnp.asarray(order), jnp.asarray(inv))
    return _TILE_PERM_CACHE[key]

__all__ = ["VolumeRenderer", "Rays", "NDCConfig", "convert_to_ndc"]

# Default pixel-group size for recorded perspective tapes: rays are
# recorded in (bh x bw) block-major order and the count sort moves whole
# blocks, so the output unsort is a gather of B/G contiguous blocks plus
# a reshape/transpose — instead of a B-row gather. Square-ish blocks
# keep chunk padding near the ray-level floor. 32 = (4 x 8) is
# semantics-free and not yet measured on the GPU (ROADMAP 1.7).
_TAPE_GROUP_DEFAULT = 32

_BLOCK_PERM_CACHE = {}


def _block_shape(G: int):
    """(bh, bw) for a G-pixel block: the most square power-of-two split
    (wider than tall on odd exponents). None when G is not a power of
    two >= 4."""
    if G < 4 or (G & (G - 1)):
        return None
    e = G.bit_length() - 1
    bw = 1 << ((e + 1) // 2)
    return G // bw, bw


def _block_perm(width: int, height: int, bh: int, bw: int):
    """Block-major pixel permutation (order, inverse): each (bh x bw)
    pixel block's rows become contiguous, blocks in row-major order.
    FIFO-capped int32 cache (an 800x800 entry is ~5 MB; unbounded
    growth would leak host memory under multi-resolution serving)."""
    key = (width, height, bh, bw)
    if key not in _BLOCK_PERM_CACHE:
        iy, ix = np.meshgrid(
            np.arange(height), np.arange(width), indexing="ij"
        )
        bid = (iy // bh) * (width // bw) + (ix // bw)
        order = np.lexsort((ix.ravel(), iy.ravel(), bid.ravel())).astype(
            np.int32
        )
        inv = np.empty(order.size, np.int32)
        inv[order] = np.arange(order.size, dtype=np.int32)
        while len(_BLOCK_PERM_CACHE) >= 8:
            _BLOCK_PERM_CACHE.pop(next(iter(_BLOCK_PERM_CACHE)))
        _BLOCK_PERM_CACHE[key] = (order, inv)
    return _BLOCK_PERM_CACHE[key]


def _tile_order(opt, width, height):
    """Tile-coherent ray permutation sized to the chunk: (perm, inv),
    or (None, None) when chunking is off. The single derivation every
    perspective entry point (and plan_persp) must share — the cost
    schedule's bit-exactness relies on the plan and the render paths
    composing the SAME tile permutation."""
    if opt.chunk_size <= 0:
        return None, None
    tile = max(8, int(np.sqrt(opt.chunk_size)))
    return _tile_perm(width, height, tile)


def convert_to_ndc(origins, directions, focal, w, h, near=1.0):
    """Convert rays to NDC coordinates (the standard NeRF NDC projection;
    capability parity: renderer.py:140-160 — kept for gradcheck parity;
    the in-kernel path normalizes dirs)."""
    # Shift each origin to the near plane along its own ray, then apply
    # the perspective NDC warp (origin and direction separately).
    t_near = -(near + origins[..., 2]) / directions[..., 2]
    origins = origins + t_near[..., None] * directions
    sx = -2.0 * focal / w
    sy = -2.0 * focal / h
    depth = origins[..., 2]
    ndc_o = jnp.stack(
        [
            sx * origins[..., 0] / depth,
            sy * origins[..., 1] / depth,
            1.0 + 2.0 * near / depth,
        ],
        -1,
    )
    ndc_d = jnp.stack(
        [
            sx * (directions[..., 0] / directions[..., 2]
                  - origins[..., 0] / depth),
            sy * (directions[..., 1] / directions[..., 2]
                  - origins[..., 1] / depth),
            -2.0 * near / depth,
        ],
        -1,
    )
    return ndc_o, ndc_d


@functools.partial(jax.jit, static_argnames=("opt",))
def _render_jit(spec, features, origins, dirs, vdirs, opt):
    return render_ops.volume_render(spec, features, origins, dirs, vdirs, opt)


@functools.partial(
    jax.jit, static_argnames=("opt", "width", "height", "fx", "fy", "want_weights")
)
def _persp_jit(spec, features, c2w, perm, inv, opt, width, height, fx, fy,
               want_weights=False):
    """Whole perspective render in ONE dispatch (ray generation, NDC,
    tile permutation, march, inverse permutation)."""
    origins, dirs = render_ops.cam2world_rays(c2w, width, height, fx, fy)
    vdirs = dirs
    if opt.ndc_width >= 0:
        dirs, origins = render_ops.world2ndc(opt, dirs, origins)
    if perm is not None:
        origins, dirs, vdirs = origins[perm], dirs[perm], vdirs[perm]
    if want_weights:
        out, waccum = render_ops.volume_render_with_weight_accum(
            spec, features, origins, dirs, vdirs, opt
        )
    else:
        out = render_ops.volume_render(spec, features, origins, dirs, vdirs, opt)
        waccum = None
    if inv is not None:
        out = out[inv]
    out = out.reshape(height, width, -1)
    return (out, waccum) if want_weights else out


@functools.partial(jax.jit, static_argnames=("opt", "unsort"))
def _tape_jit(tape, spec, features, opt, unsort):
    return tape_ops.replay_render(tape, features, opt, spec, unsort=unsort)


@functools.partial(jax.jit, static_argnames=("opt", "unsort"))
def _tape_weights_jit(tape, spec, features, opt, unsort):
    return tape_ops.replay_render_weighted(tape, features, opt, spec,
                                           unsort=unsort)


@functools.partial(jax.jit, static_argnames=("opt", "has_tm", "unsort"))
def _tape_frames_jit(tape, spec, features_frames, tmats_frames, opt,
                     has_tm, unsort):
    """T feature-stack frames replayed over ONE recorded tape in ONE
    dispatch (scan over frames; the replay body compiles once). The
    steady-state serving loop for fixed-camera animated-feature streams
    — all structure work was paid at record time. Without per-frame
    tmats this routes through `replay_render_frames` (same scanned
    forward, but gradients batch into ONE combined wide flush)."""
    import dataclasses as _dc

    if not has_tm:
        return tape_ops.replay_render_frames(
            tape, features_frames, opt, spec, unsort=unsort
        )

    def body(carry, xs):
        if has_tm:
            f, tm = xs
            sp = _dc.replace(spec, transformation_matrices=tm)
        else:
            (f,) = xs
            sp = spec
        out = tape_ops.replay_render(tape, f, opt, sp, unsort=unsort)
        return carry, out

    xs = (
        (features_frames, tmats_frames) if has_tm else (features_frames,)
    )
    _, outs = jax.lax.scan(body, 0, xs)
    return outs


@functools.partial(jax.jit, static_argnames=("opt", "has_tm"))
def _frames_jit(spec, features_frames, tmats_frames, origins, dirs, vdirs,
                opt, has_tm):
    """T ray-batch frames in ONE dispatch: lax.scan over the frame axis
    (the march body compiles once regardless of T). Serving path for
    animation streams: one dispatch per stack instead of one per
    frame."""
    import dataclasses as _dc

    def body(carry, xs):
        if has_tm:
            f, tm = xs
            sp = _dc.replace(spec, transformation_matrices=tm)
        else:
            (f,) = xs
            sp = spec
        out = render_ops.volume_render(sp, f, origins, dirs, vdirs, opt)
        return carry, out

    xs = (
        (features_frames, tmats_frames) if has_tm else (features_frames,)
    )
    _, outs = jax.lax.scan(body, 0, xs)
    return outs


@functools.partial(
    jax.jit,
    static_argnames=(
        "opt", "width", "height", "fx", "fy", "has_tm", "per_frame_cam"
    ),
)
def _persp_frames_jit(spec, features_frames, tmats_frames, c2w, perm, inv,
                      opt, width, height, fx, fy, has_tm, per_frame_cam):
    """T perspective frames in ONE dispatch (see _frames_jit). With a
    fixed camera the ray generation is hoisted out of the scan."""
    import dataclasses as _dc

    def rays_of(cam):
        origins, dirs = render_ops.cam2world_rays(cam, width, height, fx, fy)
        vdirs = dirs
        if opt.ndc_width >= 0:
            dirs, origins = render_ops.world2ndc(opt, dirs, origins)
        if perm is not None:
            origins, dirs, vdirs = origins[perm], dirs[perm], vdirs[perm]
        return origins, dirs, vdirs

    fixed_rays = None if per_frame_cam else rays_of(c2w)

    def body(carry, xs):
        xs = list(xs)
        f = xs.pop(0)
        tm = xs.pop(0) if has_tm else None
        cam = xs.pop(0) if per_frame_cam else None
        sp = _dc.replace(spec, transformation_matrices=tm) if has_tm else spec
        origins, dirs, vdirs = rays_of(cam) if per_frame_cam else fixed_rays
        out = render_ops.volume_render(sp, f, origins, dirs, vdirs, opt)
        if inv is not None:
            out = out[inv]
        return carry, out.reshape(height, width, -1)

    xs = [features_frames]
    if has_tm:
        xs.append(tmats_frames)
    if per_frame_cam:
        xs.append(c2w)
    _, outs = jax.lax.scan(body, 0, tuple(xs))
    return outs


@functools.partial(
    jax.jit,
    static_argnames=(
        "opt", "per_frame_feats", "per_frame_rays", "use_rot", "with_depth"
    ),
)
def _dynamic_frames_jit(tree_spec, baked, features, tgt_poses, src_pose,
                        points, skinning_weights, joint_index, origins,
                        dirs, vdirs, opt, per_frame_feats, per_frame_rays,
                        use_rot, with_depth=False):
    """The fused temporal pipeline (SURVEY.md §3.4) as ONE dispatch:
    per scanned frame — LBS-warp the canonical cloud by that frame's
    pose, re-point the octree (`construct_tree`), refresh the baked
    structure (one gather), and render with per-voxel view-direction
    rotation by the blended matrices. The index table and the
    occupied-AABB union are scan carries, so semantics equal the eager
    per-frame loop (tree.construct_tree + renderer.forward) exactly."""
    import dataclasses as _dc

    from ..ops import bake as bake_ops
    from ..ops import query as query_ops
    from ..ops import warp as warp_ops

    if baked is not None and baked.aabb_lo is not None:
        lo0, hi0 = baked.aabb_lo, baked.aabb_hi
    else:
        lo0 = jnp.zeros(3, jnp.float32)
        hi0 = jnp.ones(3, jnp.float32)

    def body(carry, xs):
        data_flat, lo, hi = carry
        xs = list(xs)
        tgt = xs.pop(0)
        f = xs.pop(0) if per_frame_feats else features
        if per_frame_rays:
            o_, d_, v_ = xs.pop(0), xs.pop(0), xs.pop(0)
        else:
            o_, d_, v_ = origins, dirs, vdirs
        T = warp_ops.get_transformation_matrix(src_pose, tgt)
        warped, mats = warp_ops.warp_vertices(
            T, points, skinning_weights, joint_index
        )
        spec_t = tree_spec.with_(data_flat=data_flat)
        new_flat = query_ops.construct_tree(spec_t, warped)
        plo, phi = query_ops.points_leaf_aabb(spec_t, warped)
        lo = jnp.minimum(lo, plo)
        hi = jnp.maximum(hi, phi)
        if baked is not None:
            sp = bake_ops.refresh(baked, new_flat, aabb_lo=lo, aabb_hi=hi)
            if opt.skip_boxes and baked.skip_base:
                # FAST serving: refresh degraded the bake-time skip
                # boxes; re-grow symmetric ones on device.
                sp = bake_ops.grow_boxes_device(sp)
        else:
            sp = tree_spec.with_(data_flat=new_flat)
        if use_rot:
            sp = _dc.replace(sp, transformation_matrices=mats)
        out = render_ops.volume_render(sp, f, o_, d_, v_, opt)
        if with_depth:
            from ..ops import render_aux as aux_ops

            out = (out, aux_ops.render_depth(sp, f, o_, d_, opt))
        return (new_flat, lo, hi), out

    xs = [tgt_poses]
    if per_frame_feats:
        xs.append(features)
    if per_frame_rays:
        xs += [origins, dirs, vdirs]
    carry0 = (tree_spec.data_flat, lo0, hi0)
    (data_flat, lo, hi), outs = jax.lax.scan(body, carry0, tuple(xs))
    return outs, data_flat, lo, hi


@jax.jit
def _dyn_union_jit(tree_spec, tgt_poses, src_pose, points,
                   skinning_weights, joint_index, lo0, hi0):
    """Union-occupancy pre-pass for dynamic tape recording: run the
    animation's construct_tree chain (ONE scanned dispatch — warp +
    re-point per frame, no rendering) and return (final index table,
    union cull box). Occupancy only grows across construct_tree calls
    (stale pointers persist, svox_kernel.cu:110-121 semantics), so the
    final table's occupancy IS the union over all frames."""
    from ..ops import query as query_ops
    from ..ops import warp as warp_ops

    def body(carry, tgt):
        data_flat, lo, hi = carry
        T = warp_ops.get_transformation_matrix(src_pose, tgt)
        warped, _ = warp_ops.warp_vertices(
            T, points, skinning_weights, joint_index
        )
        spec_t = tree_spec.with_(data_flat=data_flat)
        new_flat = query_ops.construct_tree(spec_t, warped)
        plo, phi = query_ops.points_leaf_aabb(spec_t, warped)
        return (new_flat, jnp.minimum(lo, plo), jnp.maximum(hi, phi)), None

    carry0 = (tree_spec.data_flat, lo0, hi0)
    (data_flat, lo, hi), _ = jax.lax.scan(body, carry0, tgt_poses)
    return data_flat, lo, hi


@functools.partial(
    jax.jit,
    static_argnames=("opt", "per_frame_feats", "use_rot", "unsort",
                     "with_depth"),
)
def _dynamic_tape_frames_jit(tape, tree_spec, features, tgt_poses,
                             src_pose, points, skinning_weights,
                             joint_index, opt, per_frame_feats, use_rot,
                             unsort, with_depth=False):
    """The fused temporal pipeline served through a data-indirect tape,
    ONE dispatch: per scanned frame — LBS warp, construct_tree re-point,
    pack the frame's index table, replay radiometry (cells resolve to
    this frame's rows; sample positions come from the tape). No bake
    refresh, no structure walk, no DDA in the frame loop. Semantics
    equal `_dynamic_frames_jit` exactly (see ops/tape.py docstring:
    bit-equal uncompacted, ~1e-7 regroup license compacted)."""
    from ..ops import query as query_ops
    from ..ops import warp as warp_ops

    def body(carry, xs):
        data_flat, lo, hi = carry
        xs = list(xs)
        tgt = xs.pop(0)
        f = xs.pop(0) if per_frame_feats else features
        T = warp_ops.get_transformation_matrix(src_pose, tgt)
        warped, mats = warp_ops.warp_vertices(
            T, points, skinning_weights, joint_index
        )
        spec_t = tree_spec.with_(data_flat=data_flat)
        new_flat = query_ops.construct_tree(spec_t, warped)
        plo, phi = query_ops.points_leaf_aabb(spec_t, warped)
        lo = jnp.minimum(lo, plo)
        hi = jnp.maximum(hi, phi)
        table = tape_ops.pack_index_table(new_flat)
        sp = (
            tree_spec.with_(transformation_matrices=mats)
            if use_rot else tree_spec
        )
        out = tape_ops.replay_render(
            tape, f, opt, sp, unsort=unsort, index_table=table
        )
        if with_depth:
            depth = tape_ops.replay_depth(
                tape, f, opt, sp, unsort=unsort, index_table=table
            )
            out = (out, depth)
        return (new_flat, lo, hi), out

    xs = [tgt_poses]
    if per_frame_feats:
        xs.append(features)
    lo0 = jnp.ones(3, jnp.float32)
    hi0 = jnp.zeros(3, jnp.float32)
    carry0 = (tree_spec.data_flat, lo0, hi0)
    (data_flat, lo, hi), outs = jax.lax.scan(body, carry0, tuple(xs))
    return outs, data_flat, lo, hi


@functools.partial(jax.jit, static_argnames=("opt",))
def _render_weights_jit(spec, features, origins, dirs, vdirs, opt):
    return render_ops.volume_render_with_weight_accum(
        spec, features, origins, dirs, vdirs, opt
    )


@functools.partial(jax.jit, static_argnames=("opt",))
def _opacity_jit(spec, features, origins, dirs, opt):
    return aux_ops.opacity_render(spec, features, origins, dirs, opt)


@functools.partial(jax.jit, static_argnames=("opt",))
def _depth_jit(spec, features, origins, dirs, opt):
    return aux_ops.render_depth(spec, features, origins, dirs, opt)


@functools.partial(jax.jit, static_argnames=("opt",))
def _motion_jit(spec, features, origins, dirs, opt):
    return aux_ops.motion_render(spec, features, origins, dirs, opt)


@functools.partial(jax.jit, static_argnames=("opt",))
def _motion_feature_jit(spec, joint_features, features, origins, dirs, opt):
    return aux_ops.motion_feature_render(
        spec, joint_features, features, origins, dirs, opt
    )



def _as_features(features):
    """Pass QuantizedFeatures through; convert arrays."""
    from ..ops.render import QuantizedFeatures

    if isinstance(features, QuantizedFeatures):
        return features
    return jnp.asarray(features)


class VolumeRenderer:
    """Volume renderer bound to an N3Tree (see module docstring)."""

    def __init__(
        self,
        tree,
        step_size: float = 1e-3,
        background_brightness: float = 1.0,
        ndc: NDCConfig = None,
        min_comp: int = 0,
        max_comp: int = -1,
        max_steps: int = 1024,
        backend: str = "baked",
        chunk_size: int = 1024,
        interp: str = "nearest",
        round_size: int = 0,
    ):
        """`backend`: "baked" (default) renders through the baked dense-top
        + brick structure (ops/bake.py — 2 gathers/sample); "tree" walks
        the raw octree (parity-identical semantics, slower).

        `interp`: "nearest" (reference semantics — leaf-constant
        features) or "trilinear" (per-sample interpolation over the 8
        neighboring cells of the leaf's resolution grid; ~8x gather
        cost, differentiable through all 8 corners)."""
        assert backend in ("tree", "baked")
        assert interp in ("nearest", "trilinear", 0, 1)
        self.interp = 1 if interp in ("trilinear", 1) else 0
        # round_size 0 = auto (see _auto_round_size).
        self.round_size = int(round_size)
        self.backend = backend
        self.chunk_size = chunk_size
        self.tree = tree
        self.step_size = step_size
        self.background_brightness = background_brightness
        self.ndc_config = ndc
        self.min_comp = min_comp
        self.max_comp = max_comp
        self.max_steps = max_steps
        if isinstance(tree.data_format, DataFormat):
            self.data_format = tree.data_format
        else:
            warnings.warn(
                "Legacy N3Tree (pre 0.2.18) without data_format, "
                "auto-infering SH deg"
            )
            ddim = tree.data_dim
            if ddim == 4:
                self.data_format = DataFormat("")
            else:
                self.data_format = DataFormat(f"SH{(ddim - 1) // 3}")
        if self.max_comp < 0:
            self.max_comp += self.data_format.basis_dim
        self.tree._weight_accum = None
        # Cost-ordered ray schedules (ops/schedule.py), keyed by
        # (camera, geometry, options); see plan_persp / plan_rays.
        self._plan_cache = {}
        # Recorded sample tapes (ops/tape.py), keyed like plans but with
        # geometry-only options; small FIFO — each tape holds device
        # arrays (~10-50 MB at 800^2).
        self._tape_cache = {}
        self._tape_cache_max = 4

    # ------------------------------------------------------------------

    def forward(self, features, rays: Rays, transformation_matrices=None,
                cuda=True, fast=False):
        """Render a batch of rays; differentiable wrt `features`.

        :param rays: Rays(origins (B,3), dirs (B,3), viewdirs (B,3))
        :return: (B, n_color + 1) colors + alpha
        """
        del cuda
        spec = self._render_spec(transformation_matrices)
        opt = self._get_options(fast)
        origins, dirs, vdirs = (
            jnp.asarray(rays.origins),
            jnp.asarray(rays.dirs),
            jnp.asarray(rays.viewdirs),
        )
        features = _as_features(features)
        if self.tree._weight_accum is not None:
            out, waccum = _render_weights_jit(
                spec, features, origins, dirs, vdirs, opt
            )
            self.tree._weight_accum = self.tree._weight_accum + waccum.reshape(
                self.tree._weight_accum.shape
            )
            return out
        return _render_jit(spec, features, origins, dirs, vdirs, opt)

    __call__ = forward

    def plan_rays(self, rays: Rays, fast=False, n_rows=None, features=None):
        """Precompute a cost-ordered ray schedule (ops/schedule.py).

        Returns (perm, inv) int32 NumPy permutations: render
        ``rays[perm]`` and read outputs back through ``inv`` (or apply
        to image rays via render_persp(..., schedule="cost"), which does
        both in-graph — but see the caveat there). Any permutation
        renders BIT-identically — plans only ever go stale (slower),
        never wrong — so reuse a plan across frames while features
        animate; re-plan when the camera or the scene structure
        changes. Pays when rays are HELD in plan order across the hot
        loop (training steps — reductions are order-invariant — or a
        raw-ray serving batch). Render plan-ordered batches with
        `_sched_options(opt)` (forward chunks 2048, backward kept at
        1024).

        :param n_rows: occupied-row bound for the cost pre-march
            (default: from `features`, else this tree's feature pool).
        :param features: the feature matrix that will be rendered (its
            row count and density column drive the cost model; defaults
            to the tree's own pool).
        """
        from ..ops.schedule import cost_order

        opt = self._get_options(fast)
        spec = self._render_spec()
        n_rows, sigmas = self._plan_sigmas(features, n_rows)
        perm = cost_order(
            spec, jnp.asarray(rays.origins), jnp.asarray(rays.dirs), opt,
            n_rows, sigmas,
        )
        inv = np.argsort(perm).astype(np.int32)
        return perm, inv

    def _plan_sigmas(self, features, n_rows):
        """(n_rows, sigmas) for the cost pre-march: the density column
        lets it predict early termination (fast mode) — a count-occupied
        proxy misorders translucent scenes)."""
        src = features if features is not None else getattr(
            self.tree, "features", None
        )
        feats = getattr(src, "q", src)  # quantized pools: row count only
        if n_rows is None:
            n_rows = int(feats.shape[0])
        if feats is src and getattr(feats, "ndim", 0) != 2:
            feats = None  # absent/odd pools: structure-only cost
        elif feats is not src:
            feats = None  # quantized: no float density column
        sigmas = (
            jnp.asarray(feats, jnp.float32)[:n_rows, -1]
            if feats is not None and int(feats.shape[0]) >= n_rows
            else None
        )
        return int(n_rows), sigmas

    def plan_persp(self, c2w, width=800, height=800, fx=1111.111,
                   fy=None, fast=False, n_rows=None, features=None,
                   block=4):
        """Cost-ordered schedule for a perspective camera (see
        plan_rays). Cached on (camera bytes, image size, tree version,
        options); render_persp(..., schedule="cost") uses it
        automatically. The schedule composes with the tile order
        (stable sort keeps tile coherence within equal-cost classes).

        ``block`` > 1 costs ONE ray per (block x block) pixel block (the
        center) and broadcasts — a block^2-fold cut of the pre-march
        (run as the chunked cost walk, ops/schedule.py). Plans are
        approximate schedules, never
        semantics: any permutation renders bit-identically; block
        granularity only trades a little chunk homogeneity. block=1
        recovers the exact per-ray plan."""
        if fy is None:
            fy = fx
        opt = self._get_options(fast)
        c2w_np = np.asarray(c2w, np.float32)
        bs = int(block)
        if bs < 1 or int(width) % bs or int(height) % bs:
            bs = 1
        key = (c2w_np.tobytes(), int(width), int(height), float(fx),
               float(fy), self.tree._ver,
               getattr(self.tree, "_occ_ver", 0), opt, bs)
        hit = self._plan_cache.get(key)
        if hit is not None:
            return hit
        spec = self._render_spec()
        n_rows, sigmas = self._plan_sigmas(features, n_rows)
        perm, inv = self._plan_persp_core(
            spec, opt, c2w_np, width, height, fx, fy, n_rows, sigmas, bs
        )
        self._plan_cache_put(key, (perm, inv))
        return perm, inv

    def _plan_persp_core(self, spec, opt, c2w_np, width, height, fx, fy,
                         n_rows, sigmas, bs):
        """The uncached perspective plan build (shared by `plan_persp`
        and the union-occupancy dynamic plan): block-subsampled cost
        pre-march over ``spec``, stable cost sort composed with the
        tile order."""
        from ..ops.schedule import ray_costs

        origins, dirs = render_ops.cam2world_rays(
            jnp.asarray(c2w_np), int(width), int(height), float(fx),
            float(fy),
        )
        if opt.ndc_width >= 0:
            # Cost the rays the march actually walks (same order as
            # _persp_jit: NDC warp, then permutation).
            dirs, origins = render_ops.world2ndc(opt, dirs, origins)
        if bs > 1:
            h2, w2 = int(height) // bs, int(width) // bs
            iy, ix = np.meshgrid(np.arange(h2), np.arange(w2),
                                 indexing="ij")
            centers = (
                (iy * bs + bs // 2) * int(width) + (ix * bs + bs // 2)
            ).ravel()
            csel = jnp.asarray(centers)
            cost_b = ray_costs(
                spec, origins[csel], dirs[csel], opt, n_rows, sigmas
            ).reshape(h2, w2)
            cost = np.repeat(
                np.repeat(cost_b, bs, axis=0), bs, axis=1
            ).ravel()
        else:
            cost = ray_costs(spec, origins, dirs, opt, n_rows, sigmas)
        tperm, _ = _tile_order(opt, width, height)
        if tperm is not None:
            tperm = np.asarray(tperm)
            order = np.argsort(cost[tperm], kind="stable")
            perm = tperm[order].astype(np.int32)
        else:
            perm = np.argsort(cost, kind="stable").astype(np.int32)
        inv = np.argsort(perm).astype(np.int32)
        return perm, inv

    def _plan_cache_put(self, key, val):
        while len(self._plan_cache) > 32:
            # FIFO-evict the oldest plan: a camera path cycling through
            # >32 poses must not wipe the whole cache on every insert
            # (each rebuild costs a pre-march dispatch + host argsort).
            self._plan_cache.pop(next(iter(self._plan_cache)))
        self._plan_cache[key] = val

    def render_persp(self, features, c2w, width=800, height=800,
                     fx=1111.111, fy=None, cuda=True, fast=False,
                     schedule="tile"):
        """Render a perspective image; differentiable wrt `features`.

        :param c2w: (3,4) or (4,4) camera-to-world matrix
        :param schedule: ray chunking order — "tile" (spatially coherent
            blocks, default) or "cost" (cost-homogeneous chunks via a
            cached per-camera plan; bit-identical output). CAVEAT: for
            single images the in-graph permutation gathers can cost
            more than the march saves — the schedule is meant for raw
            ray batches held in plan order (plan_rays + forward,
            training reductions)
        :return: (height, width, n_color + 1)
        """
        del cuda
        assert schedule in ("tile", "cost"), schedule
        if fy is None:
            fy = fx
        opt = self._get_options(fast)
        # Tile-coherent ray order (undone on output) so march chunks
        # exit together.
        perm = inv = None
        if schedule == "cost":
            perm, inv = self.plan_persp(c2w, width, height, fx, fy, fast,
                                        features=features)
            opt = self._sched_options(opt)
        else:
            perm, inv = _tile_order(opt, width, height)
        spec = self._render_spec()
        features = _as_features(features)
        c2w = jnp.asarray(c2w, jnp.float32)
        if self.tree._weight_accum is not None:
            out, waccum = _persp_jit(
                spec, features, c2w, perm, inv, opt,
                int(width), int(height), float(fx), float(fy), True,
            )
            self.tree._weight_accum = self.tree._weight_accum + waccum.reshape(
                self.tree._weight_accum.shape
            )
            return out
        return _persp_jit(
            spec, features, c2w, perm, inv, opt,
            int(width), int(height), float(fx), float(fy),
        )

    # --- recorded sample tapes (ops/tape.py) --------------------------

    def record_rays(self, rays: Rays, features=None, n_features=None,
                    fast=False, compact=True, record_cells=True,
                    chunk_size=0, group_size=1, spec=None, opt=None,
                    indirect=False, record_t=False):
        """Record a :class:`~svox_t_tpu.ops.tape.RayTape` for this ray
        batch: the march's structure walk cached per (rays x tree
        structure x geometry options). `render_tape` then replays only
        the radiometry.

        Pass `features` (or `n_features`) to fix the feature-pool row
        count — it defines the occupied/empty split the tape is
        compacted against. Record cost is two march-speed dispatches +
        a host argsort, amortized across every replay; the tape goes
        stale (raise) when the structure changes.

        `spec` / `opt` override the recording structure and options
        (used by the dynamic recorders, which record against a
        union-occupancy refresh); `indirect=True` records a
        cell-indexed tape (see ops/tape.py module docstring)."""
        if n_features is None:
            if features is None:
                raise ValueError(
                    "pass features or n_features (the feature-pool row "
                    "count defines the occupied/empty split)"
                )
            f = _as_features(features)
            n_features = (
                f.q.shape[0]
                if isinstance(f, render_ops.QuantizedFeatures)
                else f.shape[0]
            )
        if opt is None:
            opt = self._get_options(fast)
        C = int(chunk_size) or self._sched_options(opt).chunk_size
        if spec is None:
            spec = self._render_spec()
        return tape_ops.record_tape(
            spec, int(n_features), jnp.asarray(rays.origins),
            jnp.asarray(rays.dirs), jnp.asarray(rays.viewdirs), opt,
            compact=compact, record_cells=record_cells, chunk_size=C,
            group_size=group_size, indirect=indirect, record_t=record_t,
        )

    def render_tape(self, tape, features, fast=False,
                    transformation_matrices=None, unsort=True):
        """Render by replaying a recorded tape; differentiable wrt
        `features` (exact mode: single-pass tape backward; thresholded
        modes fall back to the march backward). Output matches
        `forward` on the recorded rays — bit-identically for
        `compact=False` tapes, to ~1e-6 (float regrouping, the
        round_size license) for compacted ones.

        `unsort=False` returns outputs in tape order (n_chunks*C rows,
        first rows padding) and skips the output gather — use for loss
        reductions; map rows via `tape.inv_pos`."""
        spec = self._render_spec(transformation_matrices)
        opt = self._get_options(fast)
        features = _as_features(features)
        if self.tree._weight_accum is not None:
            out, waccum = _tape_weights_jit(tape, spec, features, opt,
                                            unsort)
            self.tree._weight_accum = (
                self.tree._weight_accum
                + waccum.reshape(self.tree._weight_accum.shape)
            )
            return out
        return _tape_jit(tape, spec, features, opt, unsort)

    def record_persp(self, c2w, width=800, height=800, fx=1111.111,
                     fy=None, fast=False, features=None, n_features=None,
                     compact=True, group_size=0, record_t=False):
        """Record (and cache) a tape for a perspective camera; the
        tape's output mapping is composed so replay outputs come back
        in PIXEL order. Cached FIFO on (camera, size, tree version,
        geometry) like the plan cache.

        ``group_size`` (0 = the default, 32) sorts scanline GROUPS
        of that many pixels instead of single rays, making the output
        unsort a cheap block gather; pass 1 for the legacy ray-level
        sort. ``record_t``
        additionally records per-sample march t (+1 f32/sample),
        enabling first-hit depth replay (`tape_ops.replay_depth`). A
        cached ``record_t=True`` tape is a strict superset and serves
        ``record_t=False`` requests."""
        if fy is None:
            fy = fx
        G = int(group_size) or _TAPE_GROUP_DEFAULT
        opt = self._get_options(fast)
        spec = self._render_spec()
        c2w_np = np.asarray(c2w, np.float32)

        def mk_key(rt):
            return ("tape", c2w_np.tobytes(), int(width), int(height),
                    float(fx), float(fy), self.tree._ver,
                    getattr(self.tree, "_occ_ver", 0),
                    tape_ops._geom_key(spec, opt), bool(compact), G, rt)

        key = mk_key(bool(record_t))
        hit = self._tape_cache.get(key)
        if hit is None and not record_t:
            hit = self._tape_cache.get(mk_key(True))
        if hit is not None:
            return hit
        tape = self._record_persp_core(
            c2w_np, width, height, fx, fy, opt, G,
            features=features, n_features=n_features, fast=fast,
            compact=compact, record_t=bool(record_t),
        )
        self._tape_cache_put(key, tape)
        return tape

    def _record_persp_core(self, c2w_np, width, height, fx, fy, opt, G,
                           features=None, n_features=None, fast=False,
                           compact=True, spec=None, rec_opt=None,
                           indirect=False, record_t=False):
        """Shared perspective tape recording: (bh x bw) block-major ray
        order when the image/chunk config allows it (cheap
        reshape/transpose unsort), else pixel order with a 1-D grouped
        sort (G > 1) or the legacy tile order (G == 1). `spec`/`rec_opt`
        override the recording structure/options (dynamic recorders)."""
        import dataclasses as _dc

        blk = self._tape_block(G, width, height, opt)
        if blk is not None:
            # Block mode: record rays in (bh x bw) block-major order —
            # the count sort moves whole blocks, and the unsort is a
            # block gather + reshape/transpose back to raster order.
            bh, bw = blk
            rays, _ = self._persp_rays(c2w_np, width, height, fx, fy,
                                       opt, tile=False)
            order, inv_o = _block_perm(width, height, bh, bw)
            op = jnp.asarray(order)
            rays = Rays(rays.origins[op], rays.dirs[op], rays.viewdirs[op])
            tape = self.record_rays(
                rays, features=features, n_features=n_features,
                fast=fast, compact=compact, group_size=G,
                spec=spec, opt=rec_opt, indirect=indirect,
                record_t=record_t,
            )
            # pixel i sits at block-major position inv_o[i]
            tape = _dc.replace(
                tape, inv_pos=tape.inv_pos[jnp.asarray(inv_o)],
                out_blocks=(int(height) // bh, int(width) // bw, bh, bw),
            )
        elif G > 1:
            # No compatible 2-D block: record in PIXEL order with a 1-D
            # grouped sort (scanline runs of G; record_tape degrades G
            # to the largest divisor of ray count and chunk size). The
            # grouped unsort returns recorded-input order, which here IS
            # pixel order — tile order would be silently un-mapped
            # (grouped unsort bypasses inv_pos; see unsort_output).
            rays, _ = self._persp_rays(c2w_np, width, height, fx, fy,
                                       opt, tile=False)
            tape = self.record_rays(
                rays, features=features, n_features=n_features,
                fast=fast, compact=compact, group_size=G,
                spec=spec, opt=rec_opt, indirect=indirect,
                record_t=record_t,
            )
        else:
            rays, tinv = self._persp_rays(c2w_np, width, height, fx, fy,
                                          opt)
            tape = self.record_rays(
                rays, features=features,
                n_features=n_features, fast=fast, compact=compact,
                spec=spec, opt=rec_opt, indirect=indirect,
                record_t=record_t,
            )
            if tinv is not None:
                # compose: pixel i -> tile slot tinv[i] -> sorted row
                tape = _dc.replace(
                    tape, inv_pos=tape.inv_pos[jnp.asarray(tinv)]
                )
        return tape

    def _tape_block(self, G, width, height, opt):
        """(bh, bw) when G-pixel block recording applies to this image
        and chunking config, else None (legacy ray-level sort)."""
        shape = _block_shape(int(G))
        if shape is None:
            return None
        C = self._sched_options(opt).chunk_size
        bh, bw = shape
        if height % bh or width % bw or (C and C % G):
            return None
        return shape

    def _persp_rays(self, c2w, width, height, fx, fy, opt, tile=True):
        """The recorder's perspective ray pipeline (raygen -> optional
        NDC -> tile permutation), shared by `record_persp` and
        `record_persp_rig` so the two cannot drift. Returns (Rays,
        tile-inverse or None); ``tile=False`` keeps pixel order (group-
        sorted tapes supply their own chunk homogeneity)."""
        origins, dirs = render_ops.cam2world_rays(
            jnp.asarray(c2w, jnp.float32), int(width), int(height),
            float(fx), float(fy),
        )
        vdirs = dirs
        if opt.ndc_width >= 0:
            dirs, origins = render_ops.world2ndc(opt, dirs, origins)
        tperm, tinv = (
            _tile_order(opt, width, height) if tile else (None, None)
        )
        if tperm is not None:
            origins, dirs, vdirs = origins[tperm], dirs[tperm], vdirs[tperm]
        return Rays(origins, dirs, vdirs), tinv

    def _tape_cache_put(self, key, tape):
        while len(self._tape_cache) >= self._tape_cache_max:
            self._tape_cache.pop(next(iter(self._tape_cache)))
        self._tape_cache[key] = tape

    def record_persp_rig(self, c2ws, width=800, height=800, fx=1111.111,
                         fy=None, fast=False, features=None,
                         n_features=None, compact=True, group_size=0,
                         record_t=False):
        """Record ONE tape covering a V-camera capture rig (the Artemis
        serving configuration: a fixed multi-view rig around an animated
        volume). All V*width*height rays are recorded together, so a
        frame's entire rig renders in a single replay dispatch instead
        of one dispatch per view; `inv_pos` is
        composed so replay outputs come back in (view, pixel) order.
        Cached FIFO like `record_persp`.

        :param c2ws: (V, 4, 4) camera-to-world matrices
        :return: a RayTape with n_rays == V * width * height
        """
        if fy is None:
            fy = fx
        G = int(group_size) or _TAPE_GROUP_DEFAULT
        opt = self._get_options(fast)
        spec = self._render_spec()
        c2ws_np = np.asarray(c2ws, np.float32)
        assert c2ws_np.ndim == 3, "c2ws must be (V, 4, 4)"

        def mk_key(rt):
            return ("rig", c2ws_np.tobytes(), int(width), int(height),
                    float(fx), float(fy), self.tree._ver,
                    getattr(self.tree, "_occ_ver", 0),
                    tape_ops._geom_key(spec, opt), bool(compact), G, rt)

        key = mk_key(bool(record_t))
        hit = self._tape_cache.get(key)
        if hit is None and not record_t:
            # A record_t=True rig tape is a strict superset.
            hit = self._tape_cache.get(mk_key(True))
        if hit is not None:
            return hit
        import dataclasses as _dc

        V = c2ws_np.shape[0]
        wh = int(width) * int(height)
        blk = self._tape_block(G, width, height, opt)
        if blk is not None:
            bh, bw = blk
            order, inv_o = _block_perm(width, height, bh, bw)
            op = jnp.asarray(order)
            per_view = [
                self._persp_rays(c2ws_np[v], width, height, fx, fy, opt,
                                 tile=False)[0]
                for v in range(V)
            ]
            rays = Rays(*(jnp.concatenate([r[k][op] for r in per_view])
                          for k in range(3)))
            tape = self.record_rays(
                rays, features=features, n_features=n_features,
                fast=fast, compact=compact, group_size=G,
            )
            # (view, pixel) flat index -> block-major record position;
            # the unsort's leading reshape dim absorbs the view axis.
            pix = (
                jnp.asarray(inv_o)[None]
                + wh * jnp.arange(V)[:, None]
            ).reshape(-1)
            tape = _dc.replace(
                tape, inv_pos=tape.inv_pos[pix],
                out_blocks=(int(height) // bh, int(width) // bw, bh, bw),
            )
        else:
            per_view = [
                self._persp_rays(c2ws_np[v], width, height, fx, fy, opt)
                for v in range(V)
            ]
            tinv = per_view[0][1]
            rays = Rays(*(jnp.concatenate([r[0][k] for r in per_view])
                          for k in range(3)))
            tape = self.record_rays(
                rays, features=features, n_features=n_features, fast=fast,
                compact=compact,
            )
            if tinv is not None:
                pix = (
                    jnp.asarray(tinv)[None]
                    + wh * jnp.arange(V)[:, None]
                ).reshape(-1)
                tape = _dc.replace(tape, inv_pos=tape.inv_pos[pix])
        self._tape_cache_put(key, tape)
        return tape

    def render_persp_rig_tape(self, features, c2ws, width=800, height=800,
                              fx=1111.111, fy=None, fast=False,
                              compact=True, group_size=0):
        """Render a whole multi-view rig through one cached rig tape in
        ONE dispatch. Returns (V, height, width, n_color + 1);
        differentiable wrt `features`. For animation streams, pass the
        rig tape to `render_tape_frames` — (T, V*W*H, n_color + 1) comes
        back frame-major in (view, pixel) order."""
        if fy is None:
            fy = fx
        tape = self.record_persp_rig(
            c2ws, width, height, fx, fy, fast=fast, features=features,
            compact=compact, group_size=group_size,
        )
        out = self.render_tape(tape, features, fast=fast)
        V = int(np.asarray(c2ws).shape[0])
        return out.reshape(V, int(height), int(width), -1)

    def render_tape_frames(self, tape, features_frames,
                           transformation_matrices_frames=None, fast=False,
                           unsort=True):
        """T animation frames over one recorded tape in ONE dispatch
        (`render_frames`' tape counterpart): scan over the (T, M, D)
        feature stack, replaying only radiometry per frame.
        Differentiable wrt the stack. Returns (T, B, n_color + 1) (or
        tape order with `unsort=False`)."""
        spec = self._render_spec()
        opt = self._get_options(fast)
        assert self.tree._weight_accum is None, (
            "weight accumulation is per-render; use render_tape() inside "
            "the accumulator context"
        )
        features_frames = jnp.asarray(features_frames)
        has_tm = transformation_matrices_frames is not None
        tm = (
            jnp.asarray(transformation_matrices_frames, jnp.float32)
            if has_tm else None
        )
        return _tape_frames_jit(tape, spec, features_frames, tm, opt,
                                has_tm, unsort)

    def render_persp_tape(self, features, c2w, width=800, height=800,
                          fx=1111.111, fy=None, fast=False, compact=True,
                          group_size=0):
        """`render_persp` through a cached recorded tape: first call per
        (camera, structure, geometry) records; subsequent calls replay
        only radiometry. Returns (height, width, n_color + 1)."""
        if fy is None:
            fy = fx
        tape = self.record_persp(
            c2w, width, height, fx, fy, fast=fast, features=features,
            compact=compact, group_size=group_size,
        )
        out = self.render_tape(tape, features, fast=fast)
        return out.reshape(int(height), int(width), -1)

    def render_frames(self, features_frames, rays: Rays,
                      transformation_matrices_frames=None, fast=False):
        """Render T animation frames over one ray batch in ONE dispatch.

        An extension of the reference's per-frame loop (the
        Artemis pipeline renders each frame with a fresh feature matrix,
        renderer.py:207): the frame axis becomes a `lax.scan`, so the
        march compiles once and a whole feature stream renders without
        per-frame dispatch overhead. Differentiable wrt the stack.

        :param features_frames: (T, M, data_dim) per-frame feature pools
        :param rays: Rays with (B, 3) components, shared by all frames
        :param transformation_matrices_frames: optional (T, M, 4, 4)
            per-frame per-voxel view-direction rotations
        :return: (T, B, n_color + 1)
        """
        spec = self._render_spec()
        opt = self._get_options(fast)
        assert self.tree._weight_accum is None, (
            "weight accumulation is per-render; use forward() inside the "
            "accumulator context"
        )
        features_frames = jnp.asarray(features_frames)
        has_tm = transformation_matrices_frames is not None
        tm = (
            jnp.asarray(transformation_matrices_frames, jnp.float32)
            if has_tm else None
        )
        return _frames_jit(
            spec, features_frames, tm,
            jnp.asarray(rays.origins), jnp.asarray(rays.dirs),
            jnp.asarray(rays.viewdirs), opt, has_tm,
        )

    def render_persp_frames(self, features_frames, c2w, width=800,
                            height=800, fx=1111.111, fy=None,
                            transformation_matrices_frames=None,
                            fast=False, schedule="tile"):
        """Render T perspective frames in ONE dispatch (see
        `render_frames`). `c2w` may be a single (3|4, 4) camera shared
        by every frame or a (T, 3|4, 4) per-frame path (orbit videos).

        `schedule="cost"` uses the cached cost-ordered plan (one plan
        serves the whole feature stream; only supported for a single
        shared camera — per-frame paths keep tile order). CAVEAT: the
        plan amortizes, but the in-graph permutation + per-frame
        inverse gather do NOT, so prefer the default tile order here
        unless
        the scene's march savings are known to be large; the schedule
        pays on raw ray batches HELD in plan order (plan_rays +
        render_frames/forward).

        :return: (T, height, width, n_color + 1)
        """
        assert schedule in ("tile", "cost"), schedule
        if fy is None:
            fy = fx
        opt = self._get_options(fast)
        perm = inv = None
        if schedule == "cost" and np.asarray(c2w).ndim == 2:
            f0 = jnp.asarray(features_frames)
            f0 = f0[0] if f0.ndim == 3 else f0
            perm, inv = self.plan_persp(c2w, width, height, fx, fy, fast,
                                        features=f0)
            opt = self._sched_options(opt)
        else:
            perm, inv = _tile_order(opt, width, height)
        spec = self._render_spec()
        assert self.tree._weight_accum is None, (
            "weight accumulation is per-render; use render_persp() inside "
            "the accumulator context"
        )
        features_frames = jnp.asarray(features_frames)
        c2w = jnp.asarray(c2w, jnp.float32)
        per_frame_cam = c2w.ndim == 3
        if per_frame_cam:
            assert c2w.shape[0] == features_frames.shape[0], (
                "per-frame c2w stack must match the feature stack length"
            )
        has_tm = transformation_matrices_frames is not None
        tm = (
            jnp.asarray(transformation_matrices_frames, jnp.float32)
            if has_tm else None
        )
        return _persp_frames_jit(
            spec, features_frames, tm, c2w, perm, inv, opt,
            int(width), int(height), float(fx), float(fy), has_tm,
            per_frame_cam,
        )

    def render_dynamic_frames(self, features, tgt_poses, src_pose, points,
                              skinning_weights, joint_index, rays: Rays = None,
                              c2w=None, width=800, height=800, fx=1111.111,
                              fy=None, fast=False, viewdir_rotation=True,
                              update_tree=True, with_depth=False,
                              schedule="tile"):
        """Fused Artemis frame loop (SURVEY.md §3.4) in ONE dispatch:
        per frame, LBS-warp the canonical cloud by that frame's pose,
        re-point the octree at the warped points, refresh the baked
        render structure (one gather), and render with per-voxel
        view-direction rotation by the blended matrices — a `lax.scan`
        over frames, so a whole animation renders without per-frame
        dispatch or re-bake overhead. Semantics match the eager loop
        `construct_tree(warp_vertices(...)) + forward(...)` exactly
        (the index table and cull-box union are scan carries).

        :param features: (Q, data_dim) shared or (T, Q, data_dim)
            per-frame feature matrix (row i belongs to point i)
        :param tgt_poses: (T, J, 4, 4) per-frame joint poses
        :param src_pose: (J, 4, 4) canonical pose
        :param points: (Q, 3) canonical point cloud
        :param skinning_weights / joint_index: (Q, n_bones)
        :param rays: shared Rays (B, 3), OR `c2w` a (3|4, 4) fixed or
            (T, 3|4, 4) per-frame camera path
        :param update_tree: leave the tree pointed at the LAST frame
            (like the eager loop); False keeps the tree untouched
        :param with_depth: also return per-frame first-hit depth maps
            (the Artemis aux output), computed inside the same scan
        :param schedule: "tile" (default), "cost" (canonical-pose plan —
            goes stale under motion), or "union" (cost plan against the
            animation's UNION occupancy: conservative for every frame,
            never stale within the animation; one extra union pre-pass,
            cached per camera x animation x structure). All schedules
            render bit-identically — plans are never semantics. Tile
            stays the dynamic default; the schedules are not yet
            measured on the GPU (ROADMAP 3.3).
        :return: (T, B, n_color+1) for rays, (T, H, W, n_color+1) for
            cameras; with_depth returns (colors, depths) where depths is
            (T, B, 1) / (T, H, W, 1)
        """
        assert (rays is None) != (c2w is None), "pass exactly one of rays/c2w"
        assert schedule in ("tile", "cost", "union"), schedule
        if rays is not None and schedule in ("cost", "union"):
            # No silent no-op: a raw ray batch has no camera to plan
            # against here — order the rays yourself with plan_rays()
            # (the plan-order permutation then lives OUTSIDE the
            # dispatch, which is also the only regime where it pays).
            raise ValueError(
                f"schedule='{schedule}' requires c2w; for raw rays, "
                "reorder them with plan_rays() and pass schedule='tile'"
            )
        assert self.tree._weight_accum is None, (
            "weight accumulation is per-render; use the eager loop inside "
            "the accumulator context"
        )
        opt = self._get_options(fast)
        tree_spec = self.tree._spec()
        baked = (
            self.tree._baked_spec() if self.backend == "baked" else None
        )
        features = jnp.asarray(features)
        tgt_poses = jnp.asarray(tgt_poses, jnp.float32)
        per_frame_feats = features.ndim == 3
        if per_frame_feats:
            assert features.shape[0] == tgt_poses.shape[0]

        inv = None
        if rays is not None:
            origins = jnp.asarray(rays.origins)
            dirs = jnp.asarray(rays.dirs)
            vdirs = jnp.asarray(rays.viewdirs)
            per_frame_rays = False
            height_ = width_ = None
        else:
            if fy is None:
                fy = fx
            per_frame_rays = np.asarray(c2w).ndim == 3
            perm = None
            if (schedule == "cost" and not per_frame_rays
                    and opt.ndc_width < 0):
                # Plan on the CURRENT (canonical-pose) structure. A
                # stale plan is always CORRECT but drops both cost
                # homogeneity and tile coherence on animated content;
                # prefer the default tile order unless motion is
                # near-static.
                f0 = features[0] if features.ndim == 3 else features
                perm, inv = self.plan_persp(c2w, width, height, fx, fy,
                                            fast, features=f0)
                opt = self._sched_options(opt)
            elif (schedule == "union" and not per_frame_rays
                    and opt.ndc_width < 0):
                # Plan on the animation's UNION occupancy (round-5
                # verdict #3): conservative for EVERY frame — a ray
                # cheap under the union is cheap in all frames, so the
                # plan can never go stale within the animation (unlike
                # the canonical-pose plan above). One extra pre-pass
                # (the same union chain dynamic tapes record against).
                perm, inv = self._plan_dyn_union(
                    c2w, width, height, fx, fy, fast, tgt_poses,
                    src_pose, points, skinning_weights, joint_index,
                    features,
                )
                # NOTE: unlike the static cost path, the dynamic loop
                # keeps the tile chunk size (C=1024); not yet measured
                # on the GPU (ROADMAP 1.7).
            else:
                perm, inv = _tile_order(opt, width, height)
            c2w = jnp.asarray(c2w, jnp.float32)

            def rays_of(cam):
                o, d = render_ops.cam2world_rays(
                    cam, int(width), int(height), float(fx), float(fy)
                )
                v = d
                if opt.ndc_width >= 0:
                    d, o = render_ops.world2ndc(opt, d, o)
                if perm is not None:
                    o, d, v = o[perm], d[perm], v[perm]
                return o, d, v

            if per_frame_rays:
                assert c2w.shape[0] == tgt_poses.shape[0]
                origins, dirs, vdirs = jax.vmap(rays_of)(c2w)
            else:
                origins, dirs, vdirs = rays_of(c2w)
            height_, width_ = int(height), int(width)

        outs, data_flat, lo, hi = _dynamic_frames_jit(
            tree_spec, baked, features, tgt_poses,
            jnp.asarray(src_pose, jnp.float32),
            jnp.asarray(points, jnp.float32),
            jnp.asarray(skinning_weights, jnp.float32),
            jnp.asarray(joint_index, jnp.int32),
            origins, dirs, vdirs, opt, per_frame_feats, per_frame_rays,
            bool(viewdir_rotation), bool(with_depth),
        )
        if update_tree:
            self.tree._adopt_data_flat(tree_spec, data_flat, lo, hi)

        def _finish(o):
            if inv is not None:
                o = o[:, inv]
            if height_ is not None:
                o = o.reshape(o.shape[0], height_, width_, -1)
            return o

        if with_depth:
            colors, depths = outs
            return _finish(colors), _finish(depths)
        return _finish(outs)

    # --- data-indirect (dynamic) tapes ---------------------------------

    def _dyn_geom_options(self, fast=False) -> RenderOptions:
        """Options for dynamic-tape record/replay: occupancy-driven
        geometry accelerations (box_advance, skip boxes) are forced off
        — they shift sample positions per occupancy, which changes
        every frame under re-pointing. Thresholds (fast) remain: they
        are replay-time radiometry."""
        import dataclasses

        return dataclasses.replace(
            self._get_options(fast), box_advance=0, skip_boxes=0
        )

    def _dyn_union(self, tgt_poses, src_pose, points, skinning_weights,
                   joint_index):
        """(union spec, Q): the recording structure for dynamic tapes —
        the tree re-pointed by every frame of the animation (occupancy
        union) with the union cull box."""
        from ..ops import bake as bake_ops

        tree_spec = self.tree._spec()
        baked = (
            self.tree._baked_spec() if self.backend == "baked" else None
        )
        if baked is not None and baked.aabb_lo is not None:
            lo0, hi0 = baked.aabb_lo, baked.aabb_hi
        else:
            lo0 = jnp.zeros(3, jnp.float32)
            hi0 = jnp.ones(3, jnp.float32)
        data_flat, lo, hi = _dyn_union_jit(
            tree_spec, jnp.asarray(tgt_poses, jnp.float32),
            jnp.asarray(src_pose, jnp.float32),
            jnp.asarray(points, jnp.float32),
            jnp.asarray(skinning_weights, jnp.float32),
            jnp.asarray(joint_index, jnp.int32), lo0, hi0,
        )
        if baked is not None:
            spec_u = bake_ops.refresh(baked, data_flat, aabb_lo=lo,
                                      aabb_hi=hi)
        else:
            spec_u = tree_spec.with_(data_flat=data_flat)
        return spec_u, int(np.asarray(points).shape[0])

    def _dyn_cache_key(self, tag, parts):
        import hashlib

        h = hashlib.md5()
        for p in parts:
            h.update(np.ascontiguousarray(p).tobytes())
        return (tag, h.hexdigest(), self.tree._ver)

    def _plan_dyn_union(self, c2w, width, height, fx, fy, fast,
                        tgt_poses, src_pose, points, skinning_weights,
                        joint_index, features, block=4):
        """Cost plan against the animation's UNION occupancy (cached on
        camera x animation x structure): block-subsampled cost pre-march
        over the union spec + union cull box. Conservative across every
        frame — the plan never goes stale within the animation; like all
        plans it is a schedule, never semantics."""
        if fy is None:
            fy = fx
        opt = self._get_options(fast)
        c2w_np = np.asarray(c2w, np.float32)
        key = self._dyn_cache_key(
            ("uplan", int(width), int(height), float(fx), float(fy),
             opt, int(block)),
            (c2w_np, np.asarray(tgt_poses, np.float32),
             np.asarray(src_pose, np.float32),
             np.asarray(points, np.float32),
             np.asarray(skinning_weights, np.float32),
             np.asarray(joint_index, np.int32)),
        )
        hit = self._plan_cache.get(key)
        if hit is not None:
            return hit
        spec_u, Q = self._dyn_union(
            tgt_poses, src_pose, points, skinning_weights, joint_index
        )
        f = np.asarray(features) if features is not None else None
        sigmas = None
        if f is not None and f.ndim in (2, 3) and f.shape[-2] == Q:
            # Per-frame features: cost with the MAX density per point —
            # a ray expensive in ANY frame sorts late.
            col = f[..., -1]
            sigmas = jnp.asarray(
                col.max(axis=0) if f.ndim == 3 else col, jnp.float32
            )
        bs = int(block)
        if bs < 1 or int(width) % bs or int(height) % bs:
            bs = 1
        perm, inv = self._plan_persp_core(
            spec_u, opt, c2w_np, width, height, fx, fy, Q, sigmas, bs
        )
        self._plan_cache_put(key, (perm, inv))
        return perm, inv

    def record_dynamic_rays(self, rays: Rays, tgt_poses, src_pose, points,
                            skinning_weights, joint_index, compact=True,
                            group_size=1, record_t=False):
        """Record a data-indirect tape for a ray batch over an animation
        (see ops/tape.py): the tape survives every `construct_tree`
        re-point the animation performs — replay per frame resolves
        data rows through that frame's index table."""
        spec_u, Q = self._dyn_union(
            tgt_poses, src_pose, points, skinning_weights, joint_index
        )
        opt = self._dyn_geom_options(False)
        return self.record_rays(
            rays, n_features=Q, compact=compact, group_size=group_size,
            spec=spec_u, opt=opt, indirect=True, record_t=record_t,
        )

    def record_dynamic_persp(self, c2w, tgt_poses, src_pose, points,
                             skinning_weights, joint_index, width=800,
                             height=800, fx=1111.111, fy=None,
                             compact=True, group_size=0, record_t=False):
        """Record (and cache) a data-indirect perspective tape for an
        animation: ONE structure-walk record serves every frame of the
        `render_dynamic_tape_frames` loop (and any feature stream over
        the same poses). Cache key covers camera, image size, tree
        structure version, geometry, and the full animation inputs."""
        if fy is None:
            fy = fx
        G = int(group_size) or _TAPE_GROUP_DEFAULT
        c2w_np = np.asarray(c2w, np.float32)
        opt = self._dyn_geom_options(False)

        def mk_key(rt):
            return self._dyn_cache_key(
                ("dyn", int(width), int(height), float(fx), float(fy),
                 bool(compact), G, rt,
                 (float(opt.step_size), int(opt.max_steps),
                  int(opt.interp))),
                (c2w_np, np.asarray(tgt_poses, np.float32),
                 np.asarray(src_pose, np.float32),
                 np.asarray(points, np.float32),
                 np.asarray(skinning_weights, np.float32),
                 np.asarray(joint_index, np.int32)),
            )

        key = mk_key(bool(record_t))
        hit = self._tape_cache.get(key)
        if hit is None and not record_t:
            # A record_t=True tape is a strict superset (same structure
            # walk + the t column): serve it rather than re-recording
            # the full walk for alternating with_depth=False calls.
            hit = self._tape_cache.get(mk_key(True))
        if hit is not None:
            return hit
        spec_u, Q = self._dyn_union(
            tgt_poses, src_pose, points, skinning_weights, joint_index
        )
        tape = self._record_persp_core(
            c2w_np, int(width), int(height), float(fx), float(fy), opt, G,
            n_features=Q, compact=compact, spec=spec_u, rec_opt=opt,
            indirect=True, record_t=record_t,
        )
        self._tape_cache_put(key, tape)
        return tape

    def render_dynamic_tape_frames(self, features, tgt_poses, src_pose,
                                   points, skinning_weights, joint_index,
                                   tape=None, rays: Rays = None, c2w=None,
                                   width=800, height=800, fx=1111.111,
                                   fy=None, fast=False,
                                   viewdir_rotation=True, update_tree=True,
                                   compact=True, group_size=0,
                                   with_depth=False):
        """`render_dynamic_frames` served through a data-indirect tape:
        per frame the scan warps the cloud, re-points the octree, and
        REPLAYS recorded radiometry — no structure walk, no bake
        refresh, no DDA in the frame loop (the per-sample cost drops to
        one index-table resolve + the feature gather + compositing).
        First call per (camera, animation, structure) records the tape
        (or pass one from `record_dynamic_persp` / `record_dynamic_rays`
        explicitly). Outputs equal `render_dynamic_frames` to the
        compaction license (~1e-7; bit-equal with ``compact=False``).
        Differentiable wrt `features`. ``with_depth=True`` also returns
        per-frame first-hit depth maps replayed from the tape's recorded
        per-sample t (the tape must be recorded with ``record_t=True``;
        auto-recording here does that when with_depth is set).

        :return: (T, B, n_color+1) for rays, (T, H, W, n_color+1) for a
            camera; with_depth returns (colors, depths) with depths
            (T, B, 1) / (T, H, W, 1)
        """
        assert (rays is None) != (c2w is None) or tape is not None, (
            "pass exactly one of rays/c2w (or an explicit tape + rays=None"
            " for tape-order outputs)"
        )
        assert self.tree._weight_accum is None, (
            "weight accumulation is per-render; use the eager loop inside "
            "the accumulator context"
        )
        if tape is None:
            if c2w is not None:
                tape = self.record_dynamic_persp(
                    c2w, tgt_poses, src_pose, points, skinning_weights,
                    joint_index, width, height, fx, fy, compact=compact,
                    group_size=group_size, record_t=with_depth,
                )
            else:
                tape = self.record_dynamic_rays(
                    rays, tgt_poses, src_pose, points, skinning_weights,
                    joint_index, compact=compact,
                    group_size=max(1, int(group_size)),
                    record_t=with_depth,
                )
        if not tape.indirect:
            raise ValueError(
                "tape is not data-indirect; record with "
                "record_dynamic_persp/record_dynamic_rays"
            )
        if with_depth and tape.tval is None:
            raise ValueError(
                "with_depth needs a tape recorded with record_t=True"
            )
        opt = self._dyn_geom_options(fast)
        tree_spec = self.tree._spec()
        features = jnp.asarray(features)
        tgt_poses = jnp.asarray(tgt_poses, jnp.float32)
        per_frame_feats = features.ndim == 3
        if per_frame_feats:
            assert features.shape[0] == tgt_poses.shape[0]
        outs, data_flat, lo, hi = _dynamic_tape_frames_jit(
            tape, tree_spec, features, tgt_poses,
            jnp.asarray(src_pose, jnp.float32),
            jnp.asarray(points, jnp.float32),
            jnp.asarray(skinning_weights, jnp.float32),
            jnp.asarray(joint_index, jnp.int32),
            opt, per_frame_feats, bool(viewdir_rotation), True,
            bool(with_depth),
        )
        if update_tree:
            self.tree._adopt_data_flat(tree_spec, data_flat, lo, hi)

        def _img(o):
            if c2w is not None:
                return o.reshape(o.shape[0], int(height), int(width), -1)
            return o

        if with_depth:
            return _img(outs[0]), _img(outs[1])
        return _img(outs)

    def motion_render(self, features, rays: Rays, cuda=True, fast=False):
        """First-hit pass: (motion_feature (B, n_joints), depth (B,1),
        hit_point (B,3), data_idx (B,1)). Non-differentiable."""
        del cuda
        assert self.tree.extra_data is not None, (
            "Need extra data to store skeleton postion."
        )
        spec = self._render_spec()
        return _motion_jit(
            spec,
            _as_features(features),
            jnp.asarray(rays.origins),
            jnp.asarray(rays.dirs),
            self._get_options(fast),
        )

    def render_depth(self, features, rays: Rays, cuda=True, fast=False):
        """First-hit depth map, (B, 1)."""
        del cuda
        spec = self._render_spec()
        return _depth_jit(
            spec,
            _as_features(features),
            jnp.asarray(rays.origins),
            jnp.asarray(rays.dirs),
            self._get_options(fast),
        )

    def motion_feature_render(self, features, joint_features, skinning_weights,
                              joint_index, rays: Rays, cuda=True, fast=False):
        """Volumetric LBS-feature render; differentiable wrt
        `joint_features`. Returns (B, joint_feature_dim)."""
        del cuda
        if self.backend == "baked":
            spec = self.tree._baked_spec(
                skinning_weights=skinning_weights,
                joint_index=joint_index,
            )
        else:
            spec = self.tree._spec(
                features,
                joint_features=joint_features,
                skinning_weights=skinning_weights,
                joint_index=joint_index,
            )
        return _motion_feature_jit(
            spec,
            jnp.asarray(joint_features),
            _as_features(features),
            jnp.asarray(rays.origins),
            jnp.asarray(rays.dirs),
            self._get_options(fast),
        )

    def opacity_render(self, features, rays: Rays, cuda=True, fast=False):
        """Alpha-only render, (B, 1); differentiable wrt `features`."""
        del cuda
        spec = self._render_spec()
        return _opacity_jit(
            spec,
            _as_features(features),
            jnp.asarray(rays.origins),
            jnp.asarray(rays.dirs),
            self._get_options(fast),
        )

    # ------------------------------------------------------------------

    def _render_spec(self, transformation_matrices=None):
        if self.backend == "baked":
            return self.tree._baked_spec(
                transformation_matrices=transformation_matrices
            )
        return self.tree._spec(
            None, transformation_matrices=transformation_matrices
        )

    def _sched_options(self, opt: RenderOptions) -> RenderOptions:
        """The cost-schedule chunk design point (semantics-free):
        forward chunks of 2048 under a cost-ordered plan, the backward
        march kept at 1024 (its scatter tiers grow with the chunk).
        Applied only when the user left chunk_size at the default;
        outputs are bit-identical (chunk membership never changes
        per-ray math). Not yet measured on the GPU (ROADMAP 1.7)."""
        if self.chunk_size != 1024 or opt.chunk_size <= 0:
            return opt
        import dataclasses

        return dataclasses.replace(
            opt, chunk_size=2048,
            bwd_chunk_size=opt.bwd_chunk_size or 1024,
        )

    def _get_options(self, fast=False) -> RenderOptions:
        """Build the static RenderOptions (parity: renderer.py:408-439)."""
        if self.ndc_config is not None:
            ndc_w, ndc_h, ndc_f = (
                self.ndc_config.width,
                self.ndc_config.height,
                self.ndc_config.focal,
            )
        else:
            ndc_w, ndc_h, ndc_f = -1, -1, -1.0
        sigma_thresh = 1e-2 if fast else 0.0
        stop_thresh = 1e-2 if fast else 0.0
        # Fast mode also skips the provably-empty approach to the
        # occupied box (box_advance): the same exactness license as the
        # thresholds (the approach samples contribute nothing; removing
        # them shifts later sample positions by bounded amounts).
        box_advance = 1 if fast else 0
        # ... and crosses baked empty-space skip boxes in one step
        # (RenderOptions.skip_boxes) — the directed-skip counterpart of
        # box_advance, same accuracy license.
        skip_boxes = 1 if fast else 0
        # Attribute overrides, honored like the reference.
        if hasattr(self, "sigma_thresh"):
            sigma_thresh = self.sigma_thresh
        if hasattr(self, "stop_thresh"):
            stop_thresh = self.stop_thresh
        if hasattr(self, "box_advance"):
            box_advance = self.box_advance
        if hasattr(self, "skip_boxes"):
            skip_boxes = self.skip_boxes
        return RenderOptions(
            step_size=float(self.step_size),
            background_brightness=float(self.background_brightness),
            format=self.data_format.format,
            basis_dim=self.data_format.basis_dim,
            ndc_width=int(ndc_w),
            ndc_height=int(ndc_h),
            ndc_focal=float(ndc_f),
            min_comp=int(self.min_comp),
            max_comp=int(self.max_comp),
            sigma_thresh=float(sigma_thresh),
            stop_thresh=float(stop_thresh),
            max_steps=int(self.max_steps),
            chunk_size=int(self.chunk_size),
            interp=int(self.interp),
            round_size=self._auto_round_size(),
            box_advance=int(box_advance),
            skip_boxes=int(skip_boxes),
            # Reference-quirk hit-point compat (see RenderOptions):
            # attribute override, like sigma_thresh/stop_thresh.
            compat_hit_point=int(getattr(self, "compat_hit_point", 0)),
        )

    def _auto_round_size(self) -> int:
        """Samples per march round: 4, or 2 once the structure and
        pool tables exceed 32 MB (a working-set guess). Semantics-free;
        not yet measured on the GPU (ROADMAP 1.7)."""
        if self.round_size > 0:
            return self.round_size
        try:
            if self.backend == "baked":
                baked = self.tree._baked_spec()
                cells = baked.top.size + baked.brick.size + (
                    0 if baked.mid is None else baked.mid.size
                )
            else:
                cells = self.tree._spec().child_flat.shape[0]
            # feature-pool size estimated from the tree (the pool itself
            # is a per-call argument)
            table_bytes = 4 * cells + 4 * self.tree.n_leaves * self.tree.data_dim
        except AttributeError:
            # tree not fully constructed yet (e.g. options built before
            # refine) — real bake errors propagate
            return 4
        return 2 if table_bytes > (32 << 20) else 4
