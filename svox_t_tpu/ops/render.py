"""Differentiable volume rendering over the sparse voxel octree.

This module replaces the reference CUDA ray-marching kernels
(`svox_t/csrc/rt_kernel.cu`: `trace_ray` 221-328, `trace_ray_backward`
330-496, launchers 1362-1452) with batched JAX:

  * One **batch-level bounded march loop** (`lax.while_loop`) advances all
    rays together; each iteration performs one octree descent (fixed-depth
    loop of coalesced gathers, see ops/traversal.py), one feature gather,
    and masked front-to-back compositing. The loop exits as soon as every
    ray has terminated — the batched counterpart of CUDA's per-thread
    `while (t < tmax)`.
  * The backward pass is a hand-written `custom_vjp` that **re-marches
    twice** instead of storing per-sample state, exactly like the
    reference (rt_kernel.cu:364 "PASS 1", 438 "PASS 2").
  * Gradient scatters are XLA scatter-adds in place of the reference's
    float `atomicAdd`. The CPU backend sums them in a fixed order;
    XLA:GPU lowers them to atomics, so on the GPU two runs of one
    gradient can differ in the last bits, as the reference's do
    (docs/PARITY.md).

Radiometry parity checklist (each replicated bit-carefully):
  - tree-space dir scaling + `delta_scale = 1/||scaling*dir||`
    (rt_kernel.cu:187-199);
  - `invdir = 1/(dir + 1e-9)`, DDA on the unit cube (201-218);
  - `delta_t = (subcube_tmax - subcube_tmin)/cube_sz + step_size` (273-276);
  - `att = exp(-delta_t*delta_scale*sigma)`, composite only when
    `sigma > sigma_thresh` (279-307);
  - per-voxel view-direction rotation by `transformation_matrices[data_idx]`
    with basis re-evaluation (283-291);
  - SH/SG/ASG basis windowed to `[min_comp, max_comp]`, then sigmoid
    (293-306);
  - early stop at `light_intensity <= stop_thresh` with renormalization
    `1/(1-light)` (313-319); final alpha channel `1 - light` (317, 326);
  - miss rays output background with alpha 0 (241-247);
  - backward composites only where `sigma > 0` (not sigma_thresh) and
    ignores forward early-stop renormalization, as the reference does
    (382, 456) — identical under default thresholds;
  - the alpha-channel gradient term `delta_t*delta_scale*grad_alpha*
    light_intensity_ray` (486-490).

One deliberate fix vs the reference: when transformation matrices are
active, reference PASS 2 reuses whatever basis values PASS 1 left behind
(stale registers); we re-evaluate the rotated basis per sample.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.spec import (FORMAT_RGBA, RenderOptions, TreeSpec,
                          get_out_data_dim)
from .bake import _SKIP_BITS_SPAN, BakedTree
from .bake import lookup as _baked_lookup
from .bake import lookup_xyz as _baked_lookup_xyz
from .sh import _PREC, eval_basis
from .traversal import LeafInfo, dda_unit, descend, get_delta_scale, world2tree


def _basis_window(opt: RenderOptions) -> np.ndarray:
    """Static 0/1 mask over basis components [min_comp, max_comp]."""
    idx = np.arange(opt.basis_dim)
    return ((idx >= opt.min_comp) & (idx <= opt.max_comp)).astype(np.float32)


class QuantizedFeatures(NamedTuple):
    """Affine-quantized (int8) feature pool — inference-path rendering.

    Dequantization `q * scale + zero` (per channel) happens after each
    gather, in float math, so radiometry semantics are unchanged up to
    the quantization error of the pool itself. Quarters the pool's HBM
    footprint/bandwidth vs f32 — the lever for memory-bound deep scenes
    (the structural side of what the reference's offline
    `quantize_median_cut` compression enables, quantizer.cpp:38-157).
    NOT differentiable: rendering with a quantized pool returns zero
    (float0) feature cotangents.
    """

    q: jax.Array       # (M, D) int8
    scale: jax.Array   # (D,) float32
    zero: jax.Array    # (D,) float32


def quantize_features(features, bits: int = 8) -> QuantizedFeatures:
    """Per-channel affine quantization of an (M, D) float pool."""
    assert bits == 8, "int8 is the supported quantized pool width"
    features = jnp.asarray(features, jnp.float32)
    D = features.shape[1]
    if features.shape[0] == 0:
        # Empty pool (all-empty tree): no rows to reduce over.
        return QuantizedFeatures(
            jnp.zeros((0, D), jnp.int8),
            jnp.ones((D,), jnp.float32),
            jnp.zeros((D,), jnp.float32),
        )
    lo = jnp.min(features, axis=0)
    hi = jnp.max(features, axis=0)
    scale = jnp.maximum(hi - lo, 1e-12) / 254.0
    zero = (lo + hi) * 0.5
    q = jnp.clip(jnp.round((features - zero) / scale), -127, 127).astype(
        jnp.int8
    )
    return QuantizedFeatures(q, scale, zero)


class PackedFeatures(NamedTuple):
    """Feature pool prepared for fast per-sample gathers.

    Pools beyond _MAX_FEATURE_ROWS are packed G rows per table row
    (G a power of two), gathered by `idx >> log2(G)` and group-selected
    with a one-hot — same trick as the baked tables (see
    ops/bake.MAX_TABLE_ROWS). G == 1 keeps the plain layout.
    Packing happens ONCE per call, outside march loops. `scale`/`zero`
    non-None marks an int8 table dequantized after each gather.
    """

    table: jax.Array
    G: int
    M: int
    D: int
    scale: Optional[jax.Array] = None
    zero: Optional[jax.Array] = None
    # Model-parallel pool shard (see RenderOptions.pool_axis): `table`
    # holds only rows [row0, row0 + n_local) of the global pool; M stays
    # the GLOBAL valid-row bound. Gathers mask non-owned rows to zero and
    # the round-level helpers psum over `axis`.
    axis: Optional[str] = None
    row0: Optional[jax.Array] = None
    n_local: int = 0


# Row-count cap for the packed feature table (see ops/bake.MAX_TABLE_ROWS).
_MAX_FEATURE_ROWS = 1 << 16


def _pack_features(features) -> PackedFeatures:
    scale = zero = None
    if isinstance(features, QuantizedFeatures):
        features, scale, zero = features
    M, D = features.shape
    G = 1
    while -(-M // G) > _MAX_FEATURE_ROWS and G < 64:
        G *= 2
    if G == 1 or M == 0:
        return PackedFeatures(features, 1, M, D, scale, zero)
    rows = -(-M // G)
    pad = rows * G - M
    padded = jnp.pad(features, ((0, pad), (0, 0)))
    return PackedFeatures(padded.reshape(rows, G * D), G, M, D, scale, zero)


def _pvary_like(x, *refs):
    """Promote `x`'s shard_map varying-axes set (vma) to the union of the
    refs' — a no-op outside shard_map.

    Inside shard_map (pool-sharded rendering, parallel/render.py) loop
    carries initialized from constants are 'unvarying' while the loop
    body makes them device-varying; the vma checker requires initial
    carries to match, and correct AD transposes (psum placement for the
    sharded-pool cotangent) depend on the tracking being precise."""
    try:
        have = jax.typeof(x).vma
        want = set()
        for r in refs:
            try:
                want |= jax.typeof(r).vma
            except Exception:
                pass
        want -= have
    except Exception:
        return x
    for a in want:
        x = jax.lax.pcast(x, a, to="varying")
    return x


def apply_bwd_sizing(opt: RenderOptions) -> RenderOptions:
    """Resolve the backward-only round/chunk overrides (spec.py
    `bwd_round_size`/`bwd_chunk_size`) into plain round/chunk sizes.
    Every backward march (main render, opacity, motion-feature) calls
    this first; sizing is semantics-free (gradient parity is tested)."""
    if opt.bwd_round_size <= 0 and opt.bwd_chunk_size <= 0:
        return opt
    import dataclasses as _dc

    return _dc.replace(
        opt,
        round_size=opt.bwd_round_size or opt.round_size,
        chunk_size=opt.bwd_chunk_size or opt.chunk_size,
        bwd_round_size=0,
        bwd_chunk_size=0,
    )


def _pool_view(features, opt, spec=None) -> PackedFeatures:
    """Pack the pool for gathering, honoring `opt.pool_axis`.

    Unsharded: identical to `_pack_features`. Sharded (inside shard_map
    over `opt.pool_axis`): `features` is this device's row shard; the
    returned view gathers locally with `M` set to the GLOBAL bound
    (`opt.pool_rows`) so empty-leaf tests stay global. Callers must psum
    gathered rows over the axis (`_gather_round`/`_gather_interp` do).

    When `spec` is passed and carries baked skip boxes, the pool must
    stay below the box code space (rows >= SKIP_BASE would make empty
    cells read as occupied) — re-bake with skip_boxes=False for pools
    that large."""
    ft = _pack_features(features)
    sb = getattr(spec, "skip_base", 0) if spec is not None else 0
    if sb:
        M_glob = opt.pool_rows if opt.pool_axis is not None else ft.M
        if M_glob > sb:
            raise ValueError(
                f"feature pool has {M_glob} rows but the baked tree packs "
                f"skip boxes above row {sb}; bake with skip_boxes=False"
            )
    if opt.pool_axis is None:
        return ft
    n_local = ft.M  # rows actually present on this device
    row0 = jax.lax.axis_index(opt.pool_axis).astype(jnp.int32) * n_local
    return ft._replace(
        M=opt.pool_rows, axis=opt.pool_axis, row0=row0, n_local=n_local
    )


def _scatter_to_local(sidx, features_t: PackedFeatures, Mloc: int, opt):
    """Global gradient-scatter indices -> this shard's rows; non-owned
    (and dummy index-M) rows redirect to the drop slot `Mloc`.

    Shared by every custom-VJP backward (render + aux passes) so the
    ownership rule (own = in-shard AND sidx < global M) cannot drift
    between them."""
    if opt.pool_axis is None:
        return sidx
    loc = sidx - features_t.row0
    own = jnp.logical_and(
        jnp.logical_and(loc >= 0, loc < Mloc), sidx < features_t.M
    )
    return jnp.where(own, loc, Mloc)


def _gather_features(ft: PackedFeatures, idx: jax.Array) -> jax.Array:
    """(B,) clamped row indices -> (B, D) feature rows (dequantized).

    Sharded pools (ft.axis set): `idx` is global; non-owned rows come
    back as exact zeros — the caller psums shards into true rows."""
    own = None
    if ft.axis is not None:
        local = idx - ft.row0
        own = jnp.logical_and(local >= 0, local < ft.n_local)
        idx = jnp.where(own, local, 0)
    if ft.G == 1:
        rows = ft.table[idx]
    else:
        shift = ft.G.bit_length() - 1
        rows = ft.table[idx >> shift]  # (B, G*D)
        rows = rows.reshape(rows.shape[0], ft.G, ft.D)
        lane = (idx & (ft.G - 1))[:, None]
        oh = (
            jax.lax.broadcasted_iota(jnp.int32, (rows.shape[0], ft.G), 1)
            == lane
        )
        fill = 0 if jnp.issubdtype(ft.table.dtype, jnp.integer) else 0.0
        rows = jnp.sum(jnp.where(oh[:, :, None], rows, fill), axis=1)
    if ft.scale is not None:
        rows = rows.astype(ft.scale.dtype) * ft.scale + ft.zero
    if own is not None:
        # After dequant: non-owned rows must contribute EXACTLY zero to
        # the cross-shard psum (the dequant adds a `zero` offset).
        rows = jnp.where(own[:, None], rows, 0)
    return rows


def _ray_setup(spec: TreeSpec, origins, dirs):
    """Transform rays to tree space; returns (o, d, invdir, delta_scale,
    tmin, tmax, hit)."""
    o = world2tree(origins, spec.offset, spec.scaling)
    d, delta_scale = get_delta_scale(spec.scaling, dirs)
    invdir = 1.0 / (d + 1e-9)
    tmin, tmax = dda_unit(o, invdir)
    hit = jnp.logical_not(jnp.logical_or(tmax < 0, tmin > tmax))
    return o, d, invdir, delta_scale, tmin, tmax, hit


def _clip_to_occupied(spec, o, invdir, tmin, tmax, hit, interp=0,
                      box_advance=0):
    """EXACT ray cull against the baked occupied-cell AABB: rays missing
    it produce exactly the background (identical to marching through
    empty space), and samples beyond its exit contribute nothing — so
    `hit` is tightened and tmax clamped without changing any output.
    The march's t-sequence up to the clamp is untouched (tmin is NOT
    moved unless `box_advance`: advancing it shifts every subsequent
    sample position, so it is a FAST-mode-only option — see
    RenderOptions.box_advance). No-op for tree-walk specs (no box) —
    backend parity tests compare the two paths' outputs, which stay
    equal by the argument above.

    With trilinear interpolation (`interp`) the cull is DISABLED: interp
    draws nonzero sigma from occupied corner cells up to half a cell
    OUTSIDE the occupied box, so clamping at the box exit would drop
    boundary-skin contributions (and truncate their gradients).

    An all-empty tree is represented by an inverted box (lo > hi); the
    order-agnostic slab test below would treat it like the full cube, so
    box validity is gated explicitly (constant-folded under jit)."""
    lo = getattr(spec, "aabb_lo", None)
    if lo is None or interp:
        return tmin, tmax, hit
    hi = spec.aabb_hi
    t1 = (lo - o) * invdir
    t2 = (hi - o) * invdir
    a_lo = jnp.max(jnp.minimum(t1, t2), axis=-1)
    a_hi = jnp.min(jnp.maximum(t1, t2), axis=-1)
    box_valid = jnp.all(lo <= hi)
    hit = jnp.logical_and(
        jnp.logical_and(hit, box_valid),
        jnp.logical_and(a_hi >= jnp.maximum(a_lo, 0.0), a_hi >= tmin),
    )
    if box_advance:
        # FAST-mode-only (see RenderOptions.box_advance): start sampling
        # at the box entry. Never moves t backward.
        tmin = jnp.maximum(tmin, a_lo)
    return tmin, jnp.minimum(tmax, a_hi), hit


def _sample(spec: TreeSpec, features, o, d, invdir, t, step_size):
    """One march sample for the whole batch: leaf lookup + step length +
    density. Returns (leaf, delta_t, sigma, valid, idx).

    `features` may be a raw (M, D) array or a PackedFeatures (callers
    with march loops pre-pack once outside the loop)."""
    ft = features if isinstance(features, PackedFeatures) else _pack_features(features)
    pos = o + t[:, None] * d
    if isinstance(spec, BakedTree):
        # Baked structure: 2 gathers + arithmetic (see ops/bake.py);
        # node_flat carries the baked cell id (translate via src_map for
        # weight accumulation).
        data_idx, cube_sz, frac, cell_id = _baked_lookup(spec, pos)
        leaf = LeafInfo(data_idx=data_idx, node_flat=cell_id,
                        cube_sz=cube_sz, frac=frac)
    else:
        leaf = descend(spec, pos)
    sub_tmin, sub_tmax = dda_unit(leaf.frac, invdir)
    delta_t = (sub_tmax - sub_tmin) / leaf.cube_sz + step_size
    M, D = ft.M, ft.D
    B = pos.shape[0]
    if M == 0:
        # Empty feature pool: every leaf is empty space.
        valid = jnp.zeros((B,), bool)
        idx = jnp.zeros((B,), jnp.int32)
        feat = jnp.zeros((B, D), pos.dtype)
        sigma = jnp.zeros((B,), pos.dtype)
        return leaf, feat, delta_t, sigma, valid, idx
    valid = leaf.data_idx < M
    idx = jnp.where(valid, leaf.data_idx, 0)
    # Compute in the ray dtype: a bf16 feature pool (halves gather-table
    # bytes for big scenes) still composites and differentiates in f32.
    feat = _gather_features(ft, idx).astype(pos.dtype)
    sigma = jnp.where(valid, feat[:, -1], 0.0)
    return leaf, feat, delta_t, sigma, valid, idx


def _step_basis(spec, opt, vdirs, idx, base_basis, window):
    """Per-sample basis values, applying the per-voxel view-direction
    rotation when transformation matrices are present
    (rt_kernel.cu:283-291)."""
    if opt.format == FORMAT_RGBA:
        return None
    if spec.transformation_matrices is None:
        return base_basis
    rot = spec.transformation_matrices[idx][:, :3, :3]
    rd = jnp.einsum("bij,bj->bi", rot, vdirs, precision=_PREC)
    return eval_basis(opt.format, opt.basis_dim, rd, spec.extra_data) * window


def _colors(feat, basis_step, opt, n_color):
    """Sigmoid colors per sample, (B, n_color)."""
    if opt.format == FORMAT_RGBA:
        return jax.nn.sigmoid(feat[:, :n_color])
    B = feat.shape[0]
    coeffs = feat[:, : n_color * opt.basis_dim].reshape(B, n_color, opt.basis_dim)
    tmp = jnp.einsum("bk,bck->bc", basis_step, coeffs, precision=_PREC)
    return jax.nn.sigmoid(tmp)


# ---------------------------------------------------------------------------
# Ray chunking
#
# Each chunk's march loop exits when its own rays are done — the whole
# batch no longer pays for the slowest ray. Image-order chunks are
# spatially coherent, so per-chunk step counts track the local scene.
# ---------------------------------------------------------------------------


def _chunk_shape(opt: RenderOptions, B: int):
    C = opt.chunk_size
    if C <= 0 or B <= C:
        return None
    n = -(-B // C)
    return n, C


def _pad_chunk(arr, B, n, C, fill):
    """(B, ...) -> (n, C, ...). Padding rays must do no work and leave no
    trace (gradients, weight accumulation), so they are filled with
    constants that form a guaranteed-miss ray (origin 1e9, dir 1) or
    zeros (gradient rows)."""
    pad = n * C - B
    if pad:
        arr = jnp.concatenate(
            [arr, jnp.full((pad,) + arr.shape[1:], fill, arr.dtype)]
        )
    return arr.reshape((n, C) + arr.shape[1:])


# Fill values for (origins, dirs, viewdirs, grad_out) ray tuples.
_RAY_FILLS = (1e9, 1.0, 1.0, 0.0)


def _chunked_outputs(single_fn, opt, ray_arrays, carry_init=None, fills=_RAY_FILLS):
    """Run `single_fn(*chunk_rays[, carry])` chunk by chunk via lax.scan.

    single_fn returns (out[, new_carry]); outputs are stacked and
    un-padded to (B, ...). Returns (out, carry).
    """
    B = ray_arrays[0].shape[0]
    shape = _chunk_shape(opt, B)
    has_carry = carry_init is not None
    if shape is None:
        if has_carry:
            out, carry = single_fn(*ray_arrays, carry_init)
            return out, carry
        return single_fn(*ray_arrays), None
    n, C = shape
    chunks = tuple(
        _pad_chunk(a, B, n, C, f) for a, f in zip(ray_arrays, fills)
    )

    def body(carry, xs):
        if has_carry:
            out, carry = single_fn(*xs, carry)
        else:
            out = single_fn(*xs)
        return carry, out

    carry, outs = jax.lax.scan(body, carry_init, chunks)
    out = jax.tree_util.tree_map(
        lambda y: y.reshape((n * C,) + y.shape[2:])[:B], outs
    )
    return out, carry


def _chunked_carry(single_fn, opt, ray_arrays, carry_init, fills=_RAY_FILLS):
    """Like _chunked_outputs but single_fn only updates a carry (used by
    backward passes accumulating gradient buffers)."""
    B = ray_arrays[0].shape[0]
    shape = _chunk_shape(opt, B)
    if shape is None:
        return single_fn(*ray_arrays, carry_init)
    n, C = shape
    chunks = tuple(
        _pad_chunk(a, B, n, C, f) for a, f in zip(ray_arrays, fills)
    )

    def body(carry, xs):
        return single_fn(*xs, carry), None

    carry, _ = jax.lax.scan(body, carry_init, chunks)
    return carry


# ---------------------------------------------------------------------------
# Forward — round-based "tape" march
#
# Each while-loop iteration (a *round*) marches `opt.round_size` samples:
#   phase 1: K dependent structure lookups (the only truly sequential
#            work — each sample's position needs the previous leaf's
#            exit distance), recording (data_idx, delta_t, validity);
#   phase 2: all radiometry for the round — feature gathers, basis
#            evaluation, compositing — computed vectorized over the
#            round tape (unrolled elementwise chains XLA fuses).
# This cuts while-loop plumbing (cond reduction, carry copies) to once
# per K samples and takes the feature gather + color math off the
# critical t-dependency chain. Semantics are bit-identical to a
# sample-at-a-time march; the step cap is exact (a march takes at most
# `max_steps` samples, matching the scan oracle).
# ---------------------------------------------------------------------------


def effective_skip_base(spec, opt) -> int:
    """The skip-box sentinel base the march actually honors: FAST-mode
    directed empty-space skip (RenderOptions.skip_boxes), OFF under
    interp (boxes are not eroded for the trilinear interpolation skin).
    THE single definition of this gate — the cost scheduler
    (ops/schedule.py) must walk exactly the structure the production
    march walks, and the two once drifted when the rule was hand-copied."""
    if opt.skip_boxes and not opt.interp:
        return int(getattr(spec, "skip_base", 0) or 0)
    return 0


def _lookup_leaf_xyz(spec, oxyz, dxyz, ivxyz, t, step_size, skip_base=0):
    """Structure-only march step on unstacked per-axis coordinates — the
    whole step is elementwise math around the structure gather, fusing
    into ~2 kernels (stacked (B,3) forms cost ~4 extra ops/step).

    Returns (data_idx, delta_t, cell_id): the leaf's feature row
    (>= n_features: empty), the leaf-adaptive step length
    `(subcube_tmax - subcube_tmin)/cube_sz + step_size` (parity:
    rt_kernel.cu:273-276), and the flat cell id (weight accumulation).

    ``skip_base`` nonzero (FAST mode, see RenderOptions.skip_boxes):
    empty cells whose sentinel lane packs skip-box extents
    (ops/bake.SKIP_BASE coding) run the exit DDA against the enlarged
    guaranteed-empty box — pure extra VPU bit-math on the value the
    step already fetched. Occupied cells and plain sentinels decode to
    extent 0 and take the identical cell exit."""
    ox, oy, oz = oxyz
    dx, dy, dz = dxyz
    ivx, ivy, ivz = ivxyz
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    if isinstance(spec, BakedTree):
        data_idx, cube_sz, fx, fy, fz, cell_id = _baked_lookup_xyz(
            spec, px, py, pz
        )
    else:
        shape = px.shape
        leaf = descend(
            spec,
            jnp.stack(
                [px.reshape(-1), py.reshape(-1), pz.reshape(-1)], axis=-1
            ),
        )
        data_idx = leaf.data_idx.reshape(shape)
        cube_sz = leaf.cube_sz.reshape(shape)
        cell_id = leaf.node_flat.reshape(shape)
        fx = leaf.frac[:, 0].reshape(shape)
        fy = leaf.frac[:, 1].reshape(shape)
        fz = leaf.frac[:, 2].reshape(shape)
    # dda_unit on the unit leaf cube, unrolled per axis (elementwise only)
    if skip_base:
        bits = data_idx - skip_base
        use = jnp.logical_and(bits >= 0, bits < _SKIP_BITS_SPAN)
        bz = jnp.where(use, bits, 0)

        def _ext(shift):
            v = jax.lax.shift_right_logical(bz, shift) if shift else bz
            return jax.lax.bitwise_and(v, 15).astype(px.dtype)

        # Written so extent 0 is BIT-IDENTICAL to the plain cell DDA
        # (x + 0.0 == x, 1.0 * iv == iv): occupied samples and degraded
        # boxes (post-refresh sentinels) take exactly the no-skip path.
        elx, ely, elz = _ext(0), _ext(8), _ext(16)
        t1x = -(fx + elx) * ivx
        t2x = t1x + (1.0 + _ext(4) + elx) * ivx
        t1y = -(fy + ely) * ivy
        t2y = t1y + (1.0 + _ext(12) + ely) * ivy
        t1z = -(fz + elz) * ivz
        t2z = t1z + (1.0 + _ext(20) + elz) * ivz
    else:
        t1x = -fx * ivx
        t2x = t1x + ivx
        t1y = -fy * ivy
        t2y = t1y + ivy
        t1z = -fz * ivz
        t2z = t1z + ivz
    sub_tmin = jnp.maximum(
        jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
        jnp.minimum(t1z, t2z),
    )
    sub_tmax = jnp.minimum(
        jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
        jnp.maximum(t1z, t2z),
    )
    sub_tmin = jnp.maximum(sub_tmin, 0.0)
    sub_tmax = jnp.minimum(sub_tmax, 1e9)
    delta_t = (sub_tmax - sub_tmin) / cube_sz + step_size
    return data_idx, delta_t, cell_id, cube_sz


def _march_round(spec, opt, oxyz, dxyz, ivxyz, tmax, step0, t, active,
                 want_pos=None):
    """Phase 1: K dependent structure lookups (the only sequential work).

    Returns stacked (K, B) tape arrays (idx, dt, valid, cell[, t_at,
    cube — recorded when `want_pos` (default: interp mode) so phase 2
    can rebuild sample positions / corner cells]) plus the post-round
    (t, active)."""
    K = max(1, opt.round_size)
    if want_pos is None:
        want_pos = bool(opt.interp)
    skip_base = effective_skip_base(spec, opt)
    cap_ragged = (opt.max_steps % K) != 0
    idx_k, dt_k, val_k, cell_k, t_k, cube_k = [], [], [], [], [], []
    tt, act = t, active
    for k in range(K):
        valid = act
        if cap_ragged:
            # Exact global step cap when max_steps isn't a multiple of K
            # (compiled out otherwise: cond guarantees step0+K<=max_steps).
            valid = jnp.logical_and(valid, step0 + k < opt.max_steps)
        data_idx, delta_t, cell_id, cube_sz = _lookup_leaf_xyz(
            spec, oxyz, dxyz, ivxyz, tt, opt.step_size, skip_base
        )
        idx_k.append(data_idx)
        dt_k.append(delta_t)
        val_k.append(valid)
        cell_k.append(cell_id)
        if want_pos:
            t_k.append(tt)
            cube_k.append(cube_sz)
        tt = tt + delta_t
        act = jnp.logical_and(act, tt < tmax)
    tape = (
        jnp.stack(idx_k),
        jnp.stack(dt_k),
        jnp.stack(val_k),
        jnp.stack(cell_k),
    )
    if want_pos:
        tape = tape + (jnp.stack(t_k), jnp.stack(cube_k))
    else:
        tape = tape + (None, None)
    return tape + (tt, act)


def _interp_corners(spec, px, py, pz, cube_sz):
    """Trilinear corner cells on the sample leaf's own resolution grid:
    8 (data_idx, weight) pairs. Leaves are treated as point samples at
    their cell centers; corner positions outside [0,1] clamp to the
    border cell (clamp-to-edge)."""
    gx = px * cube_sz - 0.5
    gy = py * cube_sz - 0.5
    gz = pz * cube_sz - 0.5
    bx = jnp.floor(gx)
    by = jnp.floor(gy)
    bz = jnp.floor(gz)
    wx = gx - bx
    wy = gy - by
    wz = gz - bz
    inv = 1.0 / cube_sz
    out = []
    for i in (0, 1):
        cx = (bx + (i + 0.5)) * inv
        fx = wx if i else 1.0 - wx
        for j in (0, 1):
            cy = (by + (j + 0.5)) * inv
            fy = wy if j else 1.0 - wy
            for k in (0, 1):
                cz = (bz + (k + 0.5)) * inv
                fz = wz if k else 1.0 - wz
                if isinstance(spec, BakedTree):
                    idx_c = _baked_lookup_xyz(spec, cx, cy, cz)[0]
                else:
                    shape = cx.shape
                    leaf = descend(
                        spec,
                        jnp.stack(
                            [cx.reshape(-1), cy.reshape(-1), cz.reshape(-1)],
                            axis=-1,
                        ),
                    )
                    idx_c = leaf.data_idx.reshape(shape)
                out.append((idx_c, fx * fy * fz))
    return out


def _gather_interp(spec, features_t: PackedFeatures, px, py, pz, cube_sz,
                   dtype):
    """Trilinearly interpolated feature rows for a (K, B) round tape.
    Returns (feat (K*B, D), sigma (K, B), corners) — `corners` is the
    (data_idx, weight) list the backward scatters through. Empty corner
    cells (idx >= n_features) contribute zero."""
    K, B = px.shape
    M = features_t.M
    corners = _interp_corners(spec, px, py, pz, cube_sz)
    if M == 0:
        return (
            jnp.zeros((K * B, features_t.D), dtype),
            jnp.zeros((K, B), dtype),
            corners,
        )
    feat = jnp.zeros((K * B, features_t.D), dtype)
    for idx_c, w in corners:
        idxf = idx_c.reshape(-1)
        vf = idxf < M
        fc = _gather_features(
            features_t, jnp.where(vf, idxf, 0)
        ).astype(dtype)
        feat = feat + (w.reshape(-1) * vf)[:, None] * fc
    if features_t.axis is not None:
        feat = jax.lax.psum(feat, features_t.axis)
    sigma = feat[:, -1].reshape(K, B)
    return feat, sigma, corners


def _gather_round(features_t: PackedFeatures, idx, dtype):
    """Phase 2a: feature rows + densities for a whole (K, B) round tape
    in ONE gather. Returns (feat (K*B, D), sigma (K, B)); empty leaves
    (idx >= n_features) read row 0 and get sigma 0."""
    K, B = idx.shape
    M = features_t.M
    if M == 0:
        return (
            jnp.zeros((K * B, features_t.D), dtype),
            jnp.zeros((K, B), dtype),
        )
    vf = idx < M
    feat = _gather_features(
        features_t, jnp.where(vf, idx, 0).reshape(-1)
    ).astype(dtype)
    if features_t.axis is not None:
        feat = jax.lax.psum(feat, features_t.axis)
    sigma = jnp.where(vf, feat[:, -1].reshape(K, B), 0.0)
    return feat, sigma


def _round_sigma(spec, features_t: PackedFeatures, opt, oxyz, dxyz, t_at,
                 cube, idx, dtype):
    """Per-round (feat, sigma, corners) honoring `opt.interp`.

    Nearest mode: one bulk row gather keyed by the round's leaf ids
    (`corners` is None). Interp mode: sample positions are RECOMPUTED
    from the exact t-chain (t_at) — the single definition of interp
    sample-position semantics. Shared by the main march phase 2, the
    backward `round_quantities`, and every aux pass so forward/backward
    and main/aux sigma semantics cannot drift (the parity class
    docs/PARITY.md guards)."""
    if opt.interp:
        px = oxyz[0][None] + t_at * dxyz[0][None]
        py = oxyz[1][None] + t_at * dxyz[1][None]
        pz = oxyz[2][None] + t_at * dxyz[2][None]
        return _gather_interp(spec, features_t, px, py, pz, cube, dtype)
    feat, sigma = _gather_round(features_t, idx, dtype)
    return feat, sigma, None


def _round_colors(spec, opt, vdirs, gi_flat, feat, base_basis, window,
                  n_color, K):
    """Per-sample sigmoid colors for a round, (K, B, n_color) — one
    einsum over the stacked tape (the per-ray basis broadcasts across K;
    with per-voxel transformation matrices the rotated basis is
    re-evaluated per sample, rt_kernel.cu:283-291)."""
    KB = feat.shape[0]
    B = KB // K
    if opt.format == FORMAT_RGBA:
        return jax.nn.sigmoid(feat[:, :n_color]).reshape(K, B, n_color)
    coeffs = feat[:, : n_color * opt.basis_dim].reshape(
        K, B, n_color, opt.basis_dim
    )
    if spec.transformation_matrices is not None:
        rot = spec.transformation_matrices[gi_flat][:, :3, :3]
        rd = jnp.einsum(
            "bij,bj->bi", rot, jnp.tile(vdirs, (K, 1)), precision=_PREC
        )
        basis = (
            eval_basis(opt.format, opt.basis_dim, rd, spec.extra_data) * window
        ).reshape(K, B, opt.basis_dim)
        tmp = jnp.einsum("abk,abck->abc", basis, coeffs, precision=_PREC)
    else:
        tmp = jnp.einsum("bk,abck->abc", base_basis, coeffs, precision=_PREC)
    return jax.nn.sigmoid(tmp)


def _phase2_radiometry(spec, features_t, opt, oxyz, dxyz, vdirs, base_basis,
                       window, delta_scale, n_color, K, dtype, can_stop,
                       idx, dt, valid, t_at, cube, node_flat,
                       L, out_c, alpha, active, stopped, waccum,
                       want_weight_accum=False, n_cells=0):
    """Phase 2: radiometry for one stacked (K, B) round — feature gather,
    attenuation prefix, early-stop masks, color accumulation, optional
    weight accumulation. The SINGLE definition of in-round radiometry:
    shared by the march loop (`_volume_render_fwd_impl`) and the recorded
    sample-tape replay (`ops/tape.py`) so the two can never drift.

    `active` enters as the post-round activity (march: act_end = still
    inside tmax; replay: more tape samples remain) and leaves ANDed with
    the early-stop. `node_flat` is the flat (K*B,) tree-cell id used only
    when `want_weight_accum` (march: spec cell via src_map; replay: node
    ids recorded in the tape)."""
    B = L.shape[0]
    M = features_t.M
    feat, sigma, _ = _round_sigma(
        spec, features_t, opt, oxyz, dxyz, t_at, cube, idx, dtype,
    )
    contrib0 = jnp.logical_and(valid, sigma > opt.sigma_thresh)
    att = jnp.exp(-dt * delta_scale[None] * sigma)
    att_eff = jnp.where(contrib0, att, 1.0)
    cp = jnp.cumprod(att_eff, axis=0)  # L_after_k / L_in
    L_after = L[None] * cp
    if can_stop:
        stop0 = jnp.logical_and(
            contrib0, L_after <= opt.stop_thresh
        )
        # no stop strictly before k (the stop sample counts)
        before = (jnp.cumsum(stop0, axis=0) - stop0) == 0
        contrib = jnp.logical_and(contrib0, before)
        stop_first = jnp.logical_and(stop0, before)  # one-hot
    else:
        contrib = contrib0
    L_before = L[None] * jnp.concatenate(
        [jnp.ones((1, B), dtype), cp[:-1]], axis=0
    )
    weight = jnp.where(contrib, L_before * (1.0 - att), 0.0)

    gi_flat = (
        jnp.where(idx < M, idx, 0) if M else idx
    ).reshape(-1)
    s = _round_colors(
        spec, opt, vdirs, gi_flat, feat, base_basis, window,
        n_color, K,
    )
    out_c = out_c + jnp.sum(weight[:, :, None] * s, axis=0)

    if want_weight_accum:
        w_idx = jnp.where(
            contrib.reshape(-1), node_flat, n_cells
        )
        waccum = waccum.at[w_idx].add(
            weight.reshape(-1), mode="drop"
        )

    if can_stop:
        stop_any = jnp.any(stop_first, axis=0)
        L_stop = jnp.sum(
            jnp.where(stop_first, L_after, 0.0), axis=0
        )
        newL = jnp.where(stop_any, L_stop, L * cp[-1])
        scale = 1.0 / (1.0 - L_stop)
        out_c = jnp.where(
            stop_any[:, None], out_c * scale[:, None], out_c
        )
        alpha = jnp.where(stop_any, 1.0 - L_stop, alpha)
        stopped = jnp.logical_or(stopped, stop_any)
        active = jnp.logical_and(
            active, jnp.logical_not(stop_any)
        )
    else:
        newL = L * cp[-1]
    return newL, out_c, alpha, active, stopped, waccum


def _volume_render_fwd_impl(
    spec: TreeSpec,
    features: jax.Array,
    origins: jax.Array,
    dirs: jax.Array,
    vdirs: jax.Array,
    opt: RenderOptions,
    want_weight_accum: bool,
) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Forward ray march (chunked rounds). Returns ((B, n_color+1)
    color+alpha, optional flat (capacity*N^3,) weight accumulation)."""
    D = (
        features.q.shape[1]
        if isinstance(features, QuantizedFeatures)
        else features.shape[1]
    )
    n_color = get_out_data_dim(opt.format, opt.basis_dim, D) - 1
    dtype = origins.dtype
    K = max(1, opt.round_size)

    is_baked = isinstance(spec, BakedTree)
    n_cells = spec.n_tree_cells if is_baked else spec.child_flat.shape[0]
    waccum0 = (
        jnp.zeros((n_cells,), dtype)
        if want_weight_accum
        else jnp.zeros((1,), dtype)
    )
    waccum0 = _pvary_like(waccum0, origins)

    # Early stop (light <= stop_thresh) can never fire when the threshold
    # is <= 0 (attenuation keeps light strictly positive, matching the
    # reference); compile out its carries and per-step work then.
    can_stop = opt.stop_thresh > 0.0

    features_t = _pool_view(features, opt, spec)
    M = features_t.M

    def march(origins_, dirs_, vdirs_, waccum0_, state, cap, per_ray_stop):
        """Round-march one chunk of rays up to `cap` samples.

        state=None starts fresh rays; otherwise state is a carried
        (step0, t, L, out_c, alpha, active, stopped) tuple from an
        earlier capped march — the t-chain resumes bit-identically (the
        setup below is a pure elementwise function of origins/dirs, so
        recomputing it on gathered rays reproduces the same values).
        per_ray_stop forces (B,)-shaped alpha/stopped carries even when
        early-stop is compiled out (two-phase state must be per-ray).
        Returns ((t, L, out_c, alpha, active, stopped, hit), waccum).
        """
        B = origins_.shape[0]
        o, d, invdir, delta_scale, tmin, tmax, hit = _ray_setup(
            spec, origins_, dirs_
        )
        tmin, tmax, hit = _clip_to_occupied(
            spec, o, invdir, tmin, tmax, hit, opt.interp, opt.box_advance
        )
        # Split coordinates once per chunk; the march loop closes over the
        # per-axis arrays (elementwise-only phase 1).
        oxyz = (o[:, 0], o[:, 1], o[:, 2])
        dxyz = (d[:, 0], d[:, 1], d[:, 2])
        ivxyz = (invdir[:, 0], invdir[:, 1], invdir[:, 2])
        if opt.format != FORMAT_RGBA:
            window = jnp.asarray(_basis_window(opt))
            base_basis = (
                eval_basis(opt.format, opt.basis_dim, vdirs_, spec.extra_data)
                * window
            )
        else:
            window = None
            base_basis = None

        def cond(carry):
            step0, t, L, out_c, alpha, active, stopped, waccum = carry
            return jnp.logical_and(step0 < cap, jnp.any(active))

        def body(carry):
            step0, t, L, out_c, alpha, active, stopped, waccum = carry
            idx, dt, valid, cell, t_at, cube, t_end, act_end = _march_round(
                spec, opt, oxyz, dxyz, ivxyz, tmax, step0, t, active
            )

            # Phase 2: radiometry for the whole round, stacked over K —
            # a handful of (K, B) ops per ROUND (the per-ray prefix is a
            # K-length cumprod). Runs unconditionally: a lax.cond that
            # skipped all-empty rounds would copy carried buffers at its
            # boundaries and break fusion.
            # The radiometry body lives in `_phase2_radiometry` (shared
            # verbatim with the tape replay, ops/tape.py).
            if want_weight_accum:
                node_flat = (
                    spec.src_map[cell.reshape(-1)]
                    if is_baked
                    else cell.reshape(-1)
                )
            else:
                node_flat = None
            L, out_c, alpha, active, stopped, waccum = _phase2_radiometry(
                spec, features_t, opt, oxyz, dxyz, vdirs_, base_basis,
                window, delta_scale, n_color, K, dtype, can_stop,
                idx, dt, valid, t_at, cube, node_flat,
                L, out_c, alpha, act_end, stopped, waccum,
                want_weight_accum=want_weight_accum, n_cells=n_cells,
            )
            return step0 + K, t_end, L, out_c, alpha, active, stopped, waccum

        if state is None:
            per_ray = can_stop or per_ray_stop
            stopped0 = (
                jnp.zeros((B,), bool) if per_ray else jnp.zeros((1,), bool)
            )
            alpha0 = (
                jnp.zeros((B,), dtype) if per_ray else jnp.zeros((1,), dtype)
            )
            init = (
                jnp.zeros((), jnp.int32),
                tmin,
                _pvary_like(jnp.ones((B,), dtype), origins_),
                _pvary_like(jnp.zeros((B, n_color), dtype), origins_),
                _pvary_like(alpha0, origins_),
                hit,
                _pvary_like(stopped0, origins_),
                _pvary_like(waccum0_, origins_),
            )
        else:
            step0_in, t_in, L_in, outc_in, alpha_in, act_in, stop_in = state
            init = (step0_in, t_in, L_in, outc_in, alpha_in, act_in,
                    stop_in, waccum0_)
        _, t, L, out_c, alpha, active, stopped, waccum = jax.lax.while_loop(
            cond, body, init
        )
        return (t, L, out_c, alpha, active, stopped, hit), waccum

    def finalize(state):
        """Blend background into final per-ray march state (once, at the
        very end — identical math whether the march ran in one phase or
        two)."""
        t, L, out_c, alpha, active, stopped, hit = state
        B = L.shape[0]
        bg = opt.background_brightness
        if can_stop:
            out_c = jnp.where(
                hit[:, None],
                jnp.where(stopped[:, None], out_c, out_c + (L * bg)[:, None]),
                jnp.full((B, n_color), bg, dtype),
            )
            alpha = jnp.where(hit, jnp.where(stopped, alpha, 1.0 - L), 0.0)
        else:
            out_c = jnp.where(
                hit[:, None],
                out_c + (L * bg)[:, None],
                jnp.full((B, n_color), bg, dtype),
            )
            alpha = jnp.where(hit, 1.0 - L, 0.0)
        return jnp.concatenate([out_c, alpha[:, None]], axis=-1)

    def single(origins_, dirs_, vdirs_, waccum0_):
        state, waccum = march(
            origins_, dirs_, vdirs_, waccum0_, None, opt.max_steps, False
        )
        return finalize(state), waccum

    # Two-phase straggler schedule (opt.straggler_rounds > 0): cap every
    # chunk's march at SR rounds (phase A), then COMPACT still-active
    # rays batch-wide into dense chunks and finish them (phase B,
    # repeated while any remain). EXACT: per-ray sample sequences are
    # unchanged — only the dispatch schedule moves work between loops.
    # Pays when chunk-straggler slot waste exceeds the one-off
    # compaction gathers.
    SR = opt.straggler_rounds
    B_total = origins.shape[0]
    cap_a = SR * K
    shape = _chunk_shape(opt, B_total)
    if SR > 0 and cap_a < opt.max_steps and shape is not None:
        n_chunks, C = shape

        def single_a(origins_, dirs_, vdirs_, waccum0_):
            return march(origins_, dirs_, vdirs_, waccum0_, None, cap_a, True)

        state, waccum = _chunked_outputs(
            single_a, opt, (origins, dirs, vdirs), waccum0
        )
        # Straggler capacity: ~B/8 rays (a generous bound on measured
        # straggler fractions), padded to whole chunks; overflow is
        # handled exactly by the generation loop below.
        S = min(n_chunks, max(1, n_chunks // 8)) * C
        arange_b = jnp.arange(B_total, dtype=jnp.int32)

        def gen_cond(carry):
            st, _ = carry
            return jnp.any(st[4])  # active

        def gen_body(carry):
            (t, L, out_c, alpha, active, stopped, hit), waccum = carry
            m = active.astype(jnp.int32)
            pos = jnp.cumsum(m) - m
            tgt = jnp.where(jnp.logical_and(active, pos < S), pos, S)
            idxbuf = jnp.full((S,), B_total, jnp.int32).at[tgt].set(
                arange_b, mode="drop"
            )
            valid = idxbuf < B_total
            gidx = jnp.where(valid, idxbuf, 0)
            step0_b = jnp.asarray(cap_a, jnp.int32)
            g_state = (
                t[gidx], L[gidx], out_c[gidx], alpha[gidx],
                jnp.logical_and(active[gidx], valid), stopped[gidx],
            )
            # These reshapes are of BODY-LOCAL gathers (fresh data each
            # generation), not loop carries, so the CLAUDE.md
            # "no reshape in while bodies" rule's re-materialization
            # cost is paid once per generation by construction.
            xs = jax.tree_util.tree_map(
                lambda x: x.reshape((S // C, C) + x.shape[1:]),
                (origins[gidx], dirs[gidx], vdirs[gidx]) + g_state,
            )

            def body_b(w, chunk):
                o_, d_, v_, t_, L_, oc_, al_, ac_, sp_ = chunk
                st, w = march(
                    o_, d_, v_, w,
                    (step0_b, t_, L_, oc_, al_, ac_, sp_),
                    opt.max_steps, True,
                )
                return w, st[:-1]  # hit recomputes identically; keep A's

            waccum, outs = jax.lax.scan(body_b, waccum, xs)
            f_t, f_L, f_oc, f_al, _f_ac, f_sp = jax.tree_util.tree_map(
                lambda y: y.reshape((S,) + y.shape[2:]), outs
            )
            scat = jnp.where(valid, idxbuf, B_total)

            def put(x, v):
                return x.at[scat].set(v, mode="drop")

            return (
                (put(t, f_t), put(L, f_L), put(out_c, f_oc),
                 put(alpha, f_al),
                 # processed rays are DONE (march() finishes or hits the
                 # max_steps cap — same termination as single-phase)
                 put(active, jnp.zeros((S,), bool)),
                 put(stopped, f_sp), hit),
                waccum,
            )

        state, waccum = jax.lax.while_loop(gen_cond, gen_body, (state, waccum))
        return finalize(state), (waccum if want_weight_accum else None)

    out, waccum = _chunked_outputs(
        single, opt, (origins, dirs, vdirs), waccum0
    )
    return out, (waccum if want_weight_accum else None)


# ---------------------------------------------------------------------------
# Backward (re-march rounds, parity: rt_kernel.cu:330-496)
# ---------------------------------------------------------------------------


def _grad_rows(opt, feat, basis_step, weight, g_color, n_color):
    """Per-sample color-coefficient gradient rows (B, n_cc) plus the
    sample colors' grad dot product total_color (B,).

    SH rows are the flat outer product (weight * s(1-s) * g_color) ⊗
    basis, built with repeat/tile (2-D row buffers; reshaping big
    arrays inside a loop materializes copies)."""
    if opt.format != FORMAT_RGBA:
        B = feat.shape[0]
        coeffs = feat[:, : n_color * opt.basis_dim].reshape(
            B, n_color, opt.basis_dim
        )
        tmp = jnp.einsum("bk,bck->bc", basis_step, coeffs, precision=_PREC)
        s = jax.nn.sigmoid(tmp)
        gs = s * (1.0 - s)
        rows = (
            jnp.repeat(weight[:, None] * gs * g_color, opt.basis_dim, axis=1)
            * jnp.tile(basis_step, (1, n_color))
        )
    else:
        s = jax.nn.sigmoid(feat[:, :n_color])
        rows = weight[:, None] * s * (1.0 - s) * g_color
    total_color = jnp.sum(s * g_color, axis=-1)
    return rows, total_color


def _round_grad_rows(opt, spec, vdirs, gi_flat, feat, base_basis, window,
                     weight, g_color, n_color, K):
    """Stacked-round color-gradient rows ((K*B, n_cc)) + per-sample
    colors' grad dot product total_color (K, B). `weight` is the (K, B)
    compositing weight; `g_color` the per-ray (B, n_color) output grads
    (broadcast across K)."""
    KB = feat.shape[0]
    B = KB // K
    s = _round_colors(
        spec, opt, vdirs, gi_flat, feat, base_basis, window, n_color, K
    )  # (K, B, n_color)
    total_color = jnp.sum(s * g_color[None], axis=-1)
    if opt.format != FORMAT_RGBA:
        gs = s * (1.0 - s)
        a = (weight[:, :, None] * gs * g_color[None]).reshape(KB, n_color)
        if spec.transformation_matrices is not None:
            rot = spec.transformation_matrices[gi_flat][:, :3, :3]
            rd = jnp.einsum(
                "bij,bj->bi", rot, jnp.tile(vdirs, (K, 1)), precision=_PREC
            )
            basis = (
                eval_basis(opt.format, opt.basis_dim, rd, spec.extra_data)
                * window
            )[:, None, :]
        else:
            basis = jnp.broadcast_to(
                base_basis[None, :, None, :],
                (K, B, 1, opt.basis_dim),
            ).reshape(KB, 1, opt.basis_dim)
        # outer product by broadcasting; the (KB, C, bd) -> (KB, n_cc)
        # reshape merges minor dims (layout-preserving, no copy) - cheaper
        # than the repeat/tile construction by one materialized operand.
        rows = (a[:, :, None] * basis).reshape(KB, n_color * opt.basis_dim)
    else:
        rows = (
            weight[:, :, None] * s * (1.0 - s) * g_color[None]
        ).reshape(KB, n_color)
    return rows, total_color


def _compact_map(sidx, rows, M, cap):
    """Shared contributing-row compaction: a position map sending the
    first `cap` rows with sidx < M to the front. Returns (smap (cap,),
    pad_idx (T+1,), pad_rows (T+1, ...), pos (T,), count). Map slots beyond
    `count` (and rows overflowing `cap`) resolve to the padded dummy
    (index M, zero row); gathering `pad_idx[smap]` / `pad_rows[smap]`
    yields a dense cap-sized block of the contributing rows."""
    T = sidx.shape[0]
    live = sidx < M
    pos = jnp.cumsum(live) - 1
    count = pos[-1] + 1
    slot = jnp.where(live, jnp.minimum(pos, cap), cap)
    smap = (
        jnp.full((cap + 1,), T, jnp.int32)
        .at[slot]
        .set(jnp.arange(T, dtype=jnp.int32), mode="drop")
    )[:cap]
    pad_idx = jnp.concatenate([sidx, jnp.full((1,), M, sidx.dtype)])
    pad_rows = jnp.concatenate(
        [rows, jnp.zeros((1,) + rows.shape[1:], rows.dtype)]
    )
    return smap, pad_idx, pad_rows, pos, count


def _scatter_add_compact(grad, sidx, rows, M):
    """Scatter-add `rows` into `grad` at row indices `sidx` (index == M
    means dropped dummy), compacting to the contributing rows first.

    Built for a scatter whose cost tracks the number of rows it is
    handed, dummies and dropped rows included: build the
    contributing-sample position map once, then dispatch (lax.switch)
    to the smallest power-of-two tier that holds `count` contributing
    rows. Contributions are spatially coherent (shell crossings light up
    whole tiles), so counts are bimodal: near-zero or large; the tier
    ladder serves both. Whether the ladder pays on the GPU's atomic
    scatter is not yet measured (ROADMAP 1.6).
    """
    T = sidx.shape[0]
    # Under shard_map the scatter output varies over every manual axis
    # its inputs vary over (pool sharding: `sidx` carries axis_index);
    # the switch's skip branch returns `grad` unchanged, so its varying
    # manual axes must be lifted to the union up front or the branches'
    # output types mismatch (pure type cast, no numerics — a zeros-add
    # would flip -0.0 rows to +0.0).
    grad = _pvary_like(grad, sidx, rows)
    tiers = []
    t = 128
    while t < T:
        tiers.append(t)
        t *= 2
    if not tiers:
        return grad.at[sidx].add(rows, mode="drop")
    cap = tiers[-1]  # largest compact tier (< T)
    sample_map, pad_idx, pad_rows, _, count = _compact_map(sidx, rows, M, cap)

    def skip(g):
        return g

    def make_compact(tier):
        def compact(g):
            m = sample_map[:tier]
            return g.at[pad_idx[m]].add(pad_rows[m], mode="drop")
        return compact

    def full(g):
        return g.at[sidx].add(rows, mode="drop")

    branches = [skip] + [make_compact(t) for t in tiers] + [full]
    # branch index: 0 = skip; 1 + position of the smallest tier >= count;
    # len(tiers) + 1 = full fallback.
    branch = jnp.zeros((), jnp.int32)
    for i, t in enumerate(reversed(tiers)):
        branch = jnp.where(count <= t, len(tiers) - i, branch)
    branch = jnp.where(count > tiers[-1], len(tiers) + 1, branch)
    branch = jnp.where(count <= 0, 0, branch)
    return jax.lax.switch(branch, branches, grad)


_TAPE_BLK = 2048


def _tape_append(tape_idx, tape_rows, fill, sidx, rows, M):
    """Compact-append a round's contributing gradient rows to the global
    tape; returns (tape_idx, tape_rows, fill, spill_sidx).

    The tape trades the per-round latency-chained scatter call for a
    cheap position-map + gather + contiguous dynamic_update_slice,
    deferring the real scatter to ONE bulk call at the end. Append
    blocks are fixed at _TAPE_BLK rows; rows beyond the
    block (dense rounds) and whole rounds arriving after the tape is
    full come back as `spill_sidx` for the caller's tiered scatter —
    correctness never depends on capacity. Stale tape slots always hold
    index M (init M; block tails map through the padded row, which is
    M), so the final flush needs no fill masking. Overflow blocks are
    routed to a sacrificial block at offset `cap` (the tape is
    allocated cap + _TAPE_BLK rows)."""
    blk = _TAPE_BLK
    cap = tape_idx.shape[0] - blk
    overflow = fill > cap - blk
    smap, pad_idx, pad_rows, pos, count = _compact_map(sidx, rows, M, blk)
    live = sidx < M
    blk_idx = jnp.where(overflow, M, pad_idx[smap])
    blk_rows = pad_rows[smap]
    off = jnp.where(overflow, cap, fill)
    tape_idx = jax.lax.dynamic_update_slice(
        tape_idx, blk_idx.astype(tape_idx.dtype), (off,)
    )
    tape_rows = jax.lax.dynamic_update_slice(tape_rows, blk_rows, (off, 0))
    appended = jnp.where(overflow, 0, jnp.minimum(count, blk))
    fill = fill + ((appended + 7) & ~7)  # 8-row alignment for the dus
    spill = jnp.where(
        jnp.logical_and(live, jnp.logical_or(pos >= blk, overflow)), sidx, M
    )
    return tape_idx, tape_rows, fill, spill


def _volume_render_bwd_impl(
    spec: TreeSpec,
    features: jax.Array,
    origins: jax.Array,
    dirs: jax.Array,
    vdirs: jax.Array,
    grad_out: jax.Array,
    opt: RenderOptions,
    out_res: Optional[jax.Array] = None,
) -> jax.Array:
    """Gradient of the render wrt the feature pool, dense (M, D) —
    chunked: grad_features is the scan carry across ray chunks.

    In exact mode (sigma_thresh == 0, stop_thresh <= 0) PASS 1's ray
    totals are recoverable from the saved forward output:
    `accum_total = sum_c out[c] * g[c]` (the background term included)
    and `light_intensity_ray = 1 - out[alpha]`; the two re-march passes
    then merge into ONE (the `single_pass` path). With thresholds active
    the reference's asymmetric rules (fwd gates on sigma_thresh, bwd on
    sigma > 0) make those quantities differ, so the literal two-pass
    re-march is used (parity: rt_kernel.cu:330-496).

    Both paths march in rounds (see the forward): per round, K structure
    lookups, vectorized gradient math, and ONE gradient scatter. In
    single-pass mode the color-coefficient rows and the sigma gradient
    merge into a single (K*B, D) row scatter — the feature layout puts
    sigma in the last column, so the scatter target IS the final (M, D)
    gradient; no assembly pass."""
    opt = apply_bwd_sizing(opt)
    Mloc, D = features.shape  # this device's rows (== global when unsharded)
    n_color = get_out_data_dim(opt.format, opt.basis_dim, D) - 1
    n_cc = n_color * opt.basis_dim if opt.format != FORMAT_RGBA else n_color
    dtype = origins.dtype
    K = max(1, opt.round_size)
    features_t = _pool_view(features, opt, spec)
    M = features_t.M  # GLOBAL valid-row bound (empty-leaf test)
    single_pass = (
        opt.sigma_thresh == 0.0 and opt.stop_thresh <= 0.0 and out_res is not None
    )
    use_tape = bool(
        single_pass and opt.grad_tape_rows > 0 and not opt.interp and M > 0
        and opt.pool_axis is None
    )

    def _to_local(sidx):
        return _scatter_to_local(sidx, features_t, Mloc, opt)

    def single(origins_, dirs_, vdirs_, grad_out_, out_res_, grad_f0):
      B = origins_.shape[0]
      o, d, invdir, delta_scale, tmin, tmax, hit = _ray_setup(spec, origins_, dirs_)
      tmin, tmax, hit = _clip_to_occupied(
          spec, o, invdir, tmin, tmax, hit, opt.interp, opt.box_advance
      )
      oxyz = (o[:, 0], o[:, 1], o[:, 2])
      dxyz = (d[:, 0], d[:, 1], d[:, 2])
      ivxyz = (invdir[:, 0], invdir[:, 1], invdir[:, 2])

      if opt.format != FORMAT_RGBA:
        window = jnp.asarray(_basis_window(opt))
        base_basis = eval_basis(opt.format, opt.basis_dim, vdirs_, spec.extra_data) * window
      else:
        window = None
        base_basis = None

      g_color = grad_out_[:, :n_color]
      g_alpha = grad_out_[:, n_color]

      def march(step0, t):
          """One stacked round of structure lookups under BACKWARD rules
          (active = hit & t < tmax — rt_kernel.cu:382)."""
          active = jnp.logical_and(hit, t < tmax)
          idx, dt, valid, _, t_at, cube, t_end, _ = _march_round(
              spec, opt, oxyz, dxyz, ivxyz, tmax, step0, t, active
          )
          return idx, dt, valid, t_at, cube, t_end

      def round_quantities(idx, dt, valid, t_at, cube):
          """Gather + shared prefix quantities (contribution gates on
          sigma > 0 regardless of sigma_thresh — the reference's
          deliberate asymmetry). `corners` (interp mode) carries the
          (data_idx, weight) pairs gradients scatter through."""
          feat, sigma, corners = _round_sigma(
              spec, features_t, opt, oxyz, dxyz, t_at, cube, idx, dtype
          )
          gi_flat = (jnp.where(idx < M, idx, 0) if M else idx).reshape(-1)
          contrib = jnp.logical_and(valid, sigma > 0.0)
          att = jnp.exp(-dt * delta_scale[None] * sigma)
          att_eff = jnp.where(contrib, att, 1.0)
          cp = jnp.cumprod(att_eff, axis=0)
          return feat, gi_flat, contrib, att, cp, corners

      def scatter_grads(grad, contrib, gi_flat, corners, rows_all):
          """Scatter per-sample gradient rows (or scalars) to the feature
          pool: nearest mode writes each sample's leaf row; interp mode
          distributes to the 8 corner cells weighted by the trilinear
          weights (chain rule through feat = sum_c w_c * f_c).

          Most round slots cross empty space, so the scatter first
          COMPACTS to the contributing rows (a cheap
          scalar position scatter + gather) and only falls back to the
          full-width scatter when more than cap rows contribute."""
          cf = contrib.reshape(-1)
          if corners is None:
              sidx = jnp.where(cf, gi_flat, M)
              return _scatter_add_compact(
                  grad, _to_local(sidx), rows_all, Mloc
              )
          sidxs, rws = [], []
          for idx_c, w in corners:
              icf = idx_c.reshape(-1)
              ok = jnp.logical_and(cf, icf < M)
              wf = w.reshape(-1)
              sidxs.append(jnp.where(ok, icf, M))
              rws.append(
                  wf[:, None] * rows_all if rows_all.ndim == 2
                  else wf * rows_all
              )
          return _scatter_add_compact(
              grad, _to_local(jnp.concatenate(sidxs)),
              jnp.concatenate(rws), Mloc
          )

      def cond(carry):
          step0, t = carry[0], carry[1]
          return jnp.logical_and(
              step0 < opt.max_steps,
              jnp.any(jnp.logical_and(hit, t < tmax)),
          )

      def prefix(L, cp):
          L_before = L[None] * jnp.concatenate(
              [jnp.ones((1, B), dtype), cp[:-1]], axis=0
          )
          return L_before, L[None] * cp

      if single_pass:
          # accum starts at the ray total and is consumed front-to-back;
          # color and sigma gradients scatter together, one row per sample.
          accum_total = jnp.sum(out_res_[:, :n_color] * g_color, axis=-1)
          L_ray = 1.0 - out_res_[:, n_color]

          def body_sp(carry):
              step0, t, L, acc, grad = carry
              idx, dt, valid, t_at, cube, t_end = march(step0, t)

              def do(ops):
                  L, acc, grad = ops
                  feat, gi_flat, contrib, att, cp, corners = round_quantities(
                      idx, dt, valid, t_at, cube
                  )
                  L_before, L_after = prefix(L, cp)
                  weight = L_before * (1.0 - att)
                  rows, total_color = _round_grad_rows(
                      opt, spec, vdirs_, gi_flat, feat, base_basis, window,
                      weight, g_color, n_color, K,
                  )
                  wtc = jnp.where(contrib, weight * total_color, 0.0)
                  acc_after = acc[None] - jnp.cumsum(wtc, axis=0)
                  dts = dt * delta_scale[None]
                  g_sigma = dts * (total_color * L_after - acc_after) + (
                      dts * (g_alpha * L_ray)[None]
                  )
                  rows_full = jnp.concatenate(
                      [rows, g_sigma.reshape(-1)[:, None]], axis=-1
                  )
                  if use_tape:
                      g, tape_idx, tape_rows, fill = grad
                      sidx = jnp.where(contrib.reshape(-1), gi_flat, M)
                      tape_idx, tape_rows, fill, spill = _tape_append(
                          tape_idx, tape_rows, fill, sidx, rows_full, M
                      )
                      g = _scatter_add_compact(g, spill, rows_full, M)
                      grad = (g, tape_idx, tape_rows, fill)
                  else:
                      grad = scatter_grads(
                          grad, contrib, gi_flat, corners, rows_full
                      )
                  return L * cp[-1], acc_after[-1], grad

              L, acc, grad = do((L, acc, grad))
              return step0 + K, t_end, L, acc, grad

          init = (
              jnp.zeros((), jnp.int32),
              tmin,
              _pvary_like(jnp.ones((B,), dtype), origins_),
              accum_total,
              grad_f0,
          )
          *_, grad = jax.lax.while_loop(cond, body_sp, init)
          return grad

      # ---- PASS 1: color gradients + accum (rounds) -----------------------
      grad_c0, grad_s0 = grad_f0

      def body1(carry):
          step0, t, L, accum, grad_c = carry
          idx, dt, valid, t_at, cube, t_end = march(step0, t)

          def do(ops):
              L, accum, grad_c = ops
              feat, gi_flat, contrib, att, cp, corners = round_quantities(
                  idx, dt, valid, t_at, cube
              )
              L_before, _ = prefix(L, cp)
              weight = L_before * (1.0 - att)
              rows, total_color = _round_grad_rows(
                  opt, spec, vdirs_, gi_flat, feat, base_basis, window,
                  weight, g_color, n_color, K,
              )
              accum = accum + jnp.sum(
                  jnp.where(contrib, weight * total_color, 0.0), axis=0
              )
              grad_c = scatter_grads(grad_c, contrib, gi_flat, corners, rows)
              return L * cp[-1], accum, grad_c

          L, accum, grad_c = do((L, accum, grad_c))
          return step0 + K, t_end, L, accum, grad_c

      init1 = (
          jnp.zeros((), jnp.int32),
          tmin,
          _pvary_like(jnp.ones((B,), dtype), origins_),
          _pvary_like(jnp.zeros((B,), dtype), origins_),
          grad_c0,
      )
      _, _, L_ray, accum, grad_c = jax.lax.while_loop(cond, body1, init1)
      total_grad = jnp.sum(g_color, axis=-1)
      accum = accum + L_ray * opt.background_brightness * total_grad

      # ---- PASS 2: sigma gradients (rounds, scalar scatter) ----------------
      def body2(carry):
          step0, t, L, acc, grad_s = carry
          idx, dt, valid, t_at, cube, t_end = march(step0, t)

          def do(ops):
              L, acc, grad_s = ops
              feat, gi_flat, contrib, att, cp, corners = round_quantities(
                  idx, dt, valid, t_at, cube
              )
              L_before, L_after = prefix(L, cp)
              weight = L_before * (1.0 - att)
              s = _round_colors(
                  spec, opt, vdirs_, gi_flat, feat, base_basis, window,
                  n_color, K,
              )
              total_color = jnp.sum(s * g_color[None], axis=-1)
              wtc = jnp.where(contrib, weight * total_color, 0.0)
              acc_after = acc[None] - jnp.cumsum(wtc, axis=0)
              dts = dt * delta_scale[None]
              g_sigma = dts * (total_color * L_after - acc_after) + (
                  dts * (g_alpha * L_ray)[None]
              )
              grad_s = scatter_grads(
                  grad_s, contrib, gi_flat, corners,
                  jnp.where(contrib, g_sigma, 0.0).reshape(-1),
              )
              return L * cp[-1], acc_after[-1], grad_s

          L, acc, grad_s = do((L, acc, grad_s))
          return step0 + K, t_end, L, acc, grad_s

      init2 = (
          jnp.zeros((), jnp.int32), tmin,
          _pvary_like(jnp.ones((B,), dtype), origins_), accum, grad_s0,
      )
      *_, grad_s = jax.lax.while_loop(cond, body2, init2)
      return grad_c, grad_s

    if out_res is None:
        out_res = jnp.zeros_like(grad_out)
    out_dtype = features.dtype

    def _cast(g):
        if opt.ray_axis is not None:
            # DP cotangent reduction: every ray shard contributes rows to
            # this pool shard; shard_map cannot insert this psum into a
            # custom_vjp bwd, so it lives here (one collective per call).
            g = jax.lax.psum(g, opt.ray_axis)
        return g if g.dtype == out_dtype else g.astype(out_dtype)

    if single_pass:
        # Merged buffer: coeff columns then the sigma column. For the
        # standard layout (data_dim == n_cc + 1) its column layout equals
        # the feature layout — it IS the final gradient, no assembly.
        carry0 = _pvary_like(
            jnp.zeros((Mloc, n_cc + 1), dtype), origins, features_t.table
        )
        if use_tape:
            cap = int(opt.grad_tape_rows) + _TAPE_BLK
            # The tape carries are filled from ray-derived rows inside the
            # loop body; promote their vma like the grad buffer above or
            # shard_map rejects the while/scan carry at trace time.
            carry0 = (
                carry0,
                _pvary_like(
                    jnp.full((cap,), M, jnp.int32), origins, features_t.table
                ),
                _pvary_like(
                    jnp.zeros((cap, n_cc + 1), dtype), origins,
                    features_t.table,
                ),
                _pvary_like(
                    jnp.zeros((), jnp.int32), origins, features_t.table
                ),
            )
        buf = _chunked_carry(
            single,
            opt,
            (origins, dirs, vdirs, grad_out, out_res),
            carry0,
            fills=(1e9, 1.0, 1.0, 0.0, 0.0),
        )
        if use_tape:
            # ONE bulk scatter flushes the whole tape (stale slots carry
            # index M and drop).
            buf, tape_idx, tape_rows, _ = buf
            buf = buf.at[tape_idx].add(tape_rows, mode="drop")
        if n_cc + 1 == D:
            return _cast(buf)
        grad_f = jnp.zeros((Mloc, D), dtype)
        grad_f = grad_f.at[:, :n_cc].set(buf[:, :n_cc])
        grad_f = grad_f.at[:, D - 1].add(buf[:, n_cc])
        return _cast(grad_f)
    grad_c, grad_s = _chunked_carry(
        single,
        opt,
        (origins, dirs, vdirs, grad_out, out_res),
        (
            _pvary_like(jnp.zeros((Mloc, n_cc), dtype), origins,
                        features_t.table),
            _pvary_like(jnp.zeros((Mloc,), dtype), origins,
                        features_t.table),
        ),
        fills=(1e9, 1.0, 1.0, 0.0, 0.0),
    )
    # Assemble the dense (rows, D) feature gradient once, outside the loops.
    grad_f = jnp.zeros((Mloc, D), dtype)
    grad_f = grad_f.at[:, :n_cc].set(grad_c)
    grad_f = grad_f.at[:, D - 1].add(grad_s)
    return _cast(grad_f)


# ---------------------------------------------------------------------------
# custom_vjp wiring
# ---------------------------------------------------------------------------


def _zero_cotangent(tree):
    """Zero cotangents for a pytree, using float0 for non-inexact leaves."""

    def zero(x):
        if x is None:
            return None
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.inexact):
            return jnp.zeros_like(x)
        return np.zeros(jnp.shape(x), jax.dtypes.float0)

    return jax.tree_util.tree_map(zero, tree)


@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def volume_render(spec, features, origins, dirs, vdirs, opt: RenderOptions):
    """Differentiable per-ray volume render (parity: renderer.py:207-308 →
    rt_kernel.cu volume_render/volume_render_backward).

    :return: (B, n_color + 1) colors + alpha.
    """
    out, _ = _volume_render_fwd_impl(spec, features, origins, dirs, vdirs, opt, False)
    return out


def _vr_fwd(spec, features, origins, dirs, vdirs, opt):
    out, _ = _volume_render_fwd_impl(spec, features, origins, dirs, vdirs, opt, False)
    return out, (spec, features, origins, dirs, vdirs, out)


def _vr_bwd(opt, res, g):
    spec, features, origins, dirs, vdirs, out = res
    if isinstance(features, QuantizedFeatures):
        # Quantized pools are inference-path: no feature gradient.
        grad_features = _zero_cotangent(features)
    else:
        grad_features = _volume_render_bwd_impl(
            spec, features, origins, dirs, vdirs, g, opt, out_res=out
        )
    return (
        _zero_cotangent(spec),
        grad_features,
        jnp.zeros_like(origins),
        jnp.zeros_like(dirs),
        jnp.zeros_like(vdirs),
    )


volume_render.defvjp(_vr_fwd, _vr_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def volume_render_with_weight_accum(spec, features, origins, dirs, vdirs, opt):
    """Render that also returns per-leaf summed contribution weights
    (parity: WeightAccumulator, svox_t/svox.py:948-969 +
    rt_kernel.cu:309-311). Returns (out, weight_accum_flat).

    Differentiable wrt ``features`` (the reference accumulates weights in
    its forward kernel with backward unaffected; same here — the weight
    output is treated as non-differentiable)."""
    return _volume_render_fwd_impl(spec, features, origins, dirs, vdirs, opt, True)


def _vrwa_fwd(spec, features, origins, dirs, vdirs, opt):
    out, waccum = _volume_render_fwd_impl(
        spec, features, origins, dirs, vdirs, opt, True
    )
    return (out, waccum), (spec, features, origins, dirs, vdirs, out)


def _vrwa_bwd(opt, res, g):
    spec, features, origins, dirs, vdirs, out = res
    g_out, _g_w = g  # weight-accum output carries no gradient
    if isinstance(features, QuantizedFeatures):
        grad_features = _zero_cotangent(features)
        return (
            _zero_cotangent(spec),
            grad_features,
            jnp.zeros_like(origins),
            jnp.zeros_like(dirs),
            jnp.zeros_like(vdirs),
        )
    grad_features = _volume_render_bwd_impl(
        spec, features, origins, dirs, vdirs, g_out, opt, out_res=out
    )
    return (
        _zero_cotangent(spec),
        grad_features,
        jnp.zeros_like(origins),
        jnp.zeros_like(dirs),
        jnp.zeros_like(vdirs),
    )


volume_render_with_weight_accum.defvjp(_vrwa_fwd, _vrwa_bwd)


def volume_render_backward(spec, features, origins, dirs, vdirs, grad_out, opt):
    """Expose the raw backward (used by tests and opacity parity checks)."""
    return _volume_render_bwd_impl(spec, features, origins, dirs, vdirs, grad_out, opt)


# ---------------------------------------------------------------------------
# Camera/image rendering (parity: rt_kernel.cu:1152-1238)
# ---------------------------------------------------------------------------


def cam2world_rays(c2w, width: int, height: int, fx: float, fy: float):
    """Generate pinhole rays for every pixel (parity: rt_kernel.cu:1152-1166).

    :return: (origins (H*W, 3), dirs (H*W, 3))
    """
    c2w = jnp.asarray(c2w, jnp.float32)
    ix = jnp.arange(width, dtype=jnp.float32)
    iy = jnp.arange(height, dtype=jnp.float32)
    x = (ix[None, :] - 0.5 * width) / fx
    y = -(iy[:, None] - 0.5 * height) / fy
    x, y = jnp.broadcast_arrays(x, y)
    z = jnp.sqrt(x * x + y * y + 1.0)
    x, y, z = x / z, y / z, -1.0 / z
    dirs_cam = jnp.stack([x, y, z], axis=-1).reshape(-1, 3)
    dirs = jnp.einsum("ij,bj->bi", c2w[:3, :3], dirs_cam, precision=_PREC)
    origins = jnp.broadcast_to(c2w[:3, 3], dirs.shape)
    return origins, dirs


def world2ndc(opt: RenderOptions, dirs, origins, near: float = 1.0):
    """NDC warp (parity: rt_kernel.cu:1169-1190). Returns (dirs, origins)."""
    t = -(near + origins[..., 2]) / dirs[..., 2]
    origins = origins + t[..., None] * dirs
    ox, oy, oz = origins[..., 0], origins[..., 1], origins[..., 2]
    dx, dy, dz = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ndx = -((2 * opt.ndc_focal) / opt.ndc_width) * (dx / dz - ox / oz)
    ndy = -((2 * opt.ndc_focal) / opt.ndc_height) * (dy / dz - oy / oz)
    ndz = -2 * near / oz
    nox = -((2 * opt.ndc_focal) / opt.ndc_width) * (ox / oz)
    noy = -((2 * opt.ndc_focal) / opt.ndc_height) * (oy / oz)
    noz = 1 + 2 * near / oz
    new_dirs = jnp.stack([ndx, ndy, ndz], axis=-1)
    new_dirs = new_dirs / jnp.linalg.norm(new_dirs, axis=-1, keepdims=True)
    return new_dirs, jnp.stack([nox, noy, noz], axis=-1)
