"""Baked render structure: dense top grid + brick atlas, packed entries.

The reference traverses root-to-leaf per sample (common.cuh:62-100) —
~depth dependent gathers: each level is a random gather that waits on
the one before. This module *bakes* the octree
into a structure where locating a leaf costs **two gathers + arithmetic**:

  * ``top``: a dense (R^3,) grid at tree level T (R = N^T). A negative
    entry means the cell contains deeper subdivision and encodes a brick
    id (``-(brick_id + 1)``); otherwise the entry packs the covering
    leaf's (depth, feature row) in one int32: ``(depth << 27) | row``.
  * ``brick``: an atlas of (B^3,)-cell bricks of the same packed entries
    at the finest level — bricks exist only under subdivided top cells,
    so memory stays O(occupied).
  * ``mid`` (very deep trees): an optional MIDDLE brick stage between
    top and fine bricks (top entry < 0 -> mid brick; mid entry < 0 ->
    fine brick). Fine bricks are capped at 3 levels by default — beyond
    that a single-stage atlas cubes in size (4+ levels = 4096+ cells
    per brick).

Per sample: gather top cell -> maybe gather mid/brick cells -> unpack
``depth``, compute ``cube_sz = N^(depth+1)`` and the in-leaf fractional
coordinates arithmetically (`frac = pos * cube_sz mod 1`). This
reproduces the reference's leaf-adaptive stepping exactly (up to float
rounding in the fraction computation, ~1e-6 — validated exact on the
test scenes), while replacing ~`depth` dependent gathers with 2.

Empty cells pack the row sentinel ``EMPTY_ROW`` (2^27 - 1); any packed
row >= n_features means empty space, mirroring the index-table contract.
Feature pools are limited to 2^27 - 1 rows (134M) in baked mode.

Per-frame `construct_tree` updates only change the *index table*; the
bake keeps a source map (baked cell -> flat tree cell) and the packed
depth parts, so refreshing after re-pointing is one gather + or
(`refresh`), entirely on device.

Baking itself runs on host NumPy arrays (pass them directly via
``bake_arrays`` — pulling spec tensors back from the device is
slow).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.spec import TreeSpec

ROW_BITS = 27
EMPTY_ROW = (1 << ROW_BITS) - 1
ROW_MASK = EMPTY_ROW

# --- Directed empty-space skip boxes (FAST-mode acceleration) --------------
#
# Every packed row value in [n_features, EMPTY_ROW] already means "empty
# space" at render time, so the sentinel lane of an EMPTY cell has
# ~2^27 - n_features spare codes — room to smuggle a per-leaf skip box
# into the very value the march already fetches (zero extra gathers).
# Empty leaves store ``SKIP_BASE + bits`` where ``bits`` packs six 4-bit
# face extents (units of the leaf's own cell size) of an axis-aligned
# box, grown greedily at bake time, that is GUARANTEED to contain no
# occupied cell. The fast-mode march exits that box instead of the
# single cell — grazing rays that would crawl through dozens of
# shell-adjacent empty leaves (65% of all real samples on the headline
# scene) cross them in one step. Exact mode ignores the extents (the
# empty test `row >= n_features` is unchanged), and `refresh()`
# re-packing rows from the index table degrades every box to a plain
# sentinel (EMPTY_ROW decodes as out-of-range -> extent 0) — stale boxes
# can never survive a re-point, so the skip is always conservative.
#
# Bit layout (low to high): lo_x, hi_x, lo_y, hi_y, lo_z, hi_z — 4 bits
# each, 24 bits total; SKIP_BASE + bits < EMPTY_ROW always holds.
SKIP_BASE = 1 << 26
_SKIP_EXT_MAX = 15
_SKIP_BITS_SPAN = 1 << 24
# Fine-grid cap for the bake-time occupancy SAT (memory: (F+1)^3 int32).
_SKIP_MAX_FINE = 256

# Max rows per packed table; larger tables get wider rows instead.
# Semantics-free; not yet measured on the GPU (ROADMAP 1.7).
MAX_TABLE_ROWS = 1 << 16


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BakedTree:
    """Render-optimized octree (see module docstring).

    Array leaves:
      top:   (rows, top_width) int32 — packed (depth<<27|row), or
             -(brick_id+1); row-packed with adaptive width.
      brick: (rows, brick_width) int32 — packed entries, row-packed.
      src_map: (R^3 + n_bricks * B^3,) int32 — flat tree-cell index each
               baked cell's row came from (for refresh / weight accum).
      depth_parts: same length — precomputed (depth << 27) per baked cell.
      offset / scaling: world->tree transform (copied from the spec).
      extra_data / transformation_matrices: optional aux (as TreeSpec).
    """

    top: jax.Array
    brick: jax.Array
    src_map: jax.Array
    depth_parts: jax.Array
    offset: jax.Array
    scaling: jax.Array
    # Optional MIDDLE brick stage for very deep trees (depth >= 10):
    # top entry < 0 -> mid brick; mid entry < 0 -> fine brick. Keeps
    # each atlas O(occupied) where a two-stage bake's fine bricks would
    # cube in size. None/mid_levels == 0 = two-stage (top -> brick).
    mid: Optional[jax.Array] = None
    extra_data: Optional[jax.Array] = None
    transformation_matrices: Optional[jax.Array] = None
    # Per-point LBS attributes (indexed by data_idx like the feature
    # pool; carried unbaked) — lets the baked backend drive
    # motion_feature_render.
    skinning_weights: Optional[jax.Array] = None
    joint_index: Optional[jax.Array] = None
    # Tree-space AABB of DATA-OCCUPIED leaf cells. Rays that miss it
    # produce exactly the background (occupied cells are all inside), so
    # the renderer culls them and clamps tmax to the AABB exit — an
    # EXACT optimization (samples beyond the exit contribute nothing).
    # None = no culling (whole cube).
    aabb_lo: Optional[jax.Array] = None
    aabb_hi: Optional[jax.Array] = None
    N: int = dataclasses.field(default=2, metadata=dict(static=True))
    top_levels: int = dataclasses.field(default=5, metadata=dict(static=True))
    brick_levels: int = dataclasses.field(default=0, metadata=dict(static=True))
    mid_levels: int = dataclasses.field(default=0, metadata=dict(static=True))
    mid_width: int = dataclasses.field(default=8, metadata=dict(static=True))
    n_tree_cells: int = dataclasses.field(default=0, metadata=dict(static=True))
    # Row widths of the packed tables (power of two), chosen so each
    # table has at most MAX_TABLE_ROWS rows.
    top_width: int = dataclasses.field(default=8, metadata=dict(static=True))
    brick_width: int = dataclasses.field(default=8, metadata=dict(static=True))
    # Nonzero when empty cells carry packed skip-box extents (== the
    # SKIP_BASE the extents are coded above). The FAST-mode march
    # (RenderOptions.skip_boxes) decodes them; exact mode ignores them.
    skip_base: int = dataclasses.field(default=0, metadata=dict(static=True))
    # Model-parallel brick atlas (huge scenes): mesh axis the brick
    # table is ROW-sharded over (inside shard_map). Each fine-brick
    # lookup gathers locally (non-owned elements read 0) and one
    # lax.psum per march step assembles the true entry — exactly one
    # shard owns any element, and non-owned contributions are exact
    # zeros, so the reduction is exact (a legitimately-zero entry still
    # sums to itself). top/mid/src_map stay replicated (they are the
    # small part). See parallel/render.py::shard_baked.
    brick_axis: Optional[str] = dataclasses.field(
        default=None, metadata=dict(static=True)
    )

    @property
    def R(self) -> int:
        return self.N ** self.top_levels

    @property
    def B(self) -> int:
        return self.N ** self.brick_levels

    @property
    def M1(self) -> int:
        return self.N ** self.mid_levels


def _leaf_cells(child: np.ndarray, parent_depth: np.ndarray, n_internal: int):
    """Enumerate all leaf cells breadth-first (host NumPy).

    :param child: (n_nodes, N, N, N) int32 relative offsets
    :return: (corner_f (L,3) int64 finest-grid units, depth (L,),
              src_flat (L,), D) with D = max node depth + 1.
    """
    N = child.shape[1]
    max_depth = int(parent_depth[: max(n_internal, 1), 1].max()) if len(parent_depth) else 0
    D = max_depth + 1
    F = N ** D

    cells_corner, cells_depth, cells_src = [], [], []
    nodes = np.array([0], np.int64)
    corners = np.zeros((1, 3), np.int64)
    u, v, w = np.meshgrid(np.arange(N), np.arange(N), np.arange(N), indexing="ij")
    uvw = np.stack([u.ravel(), v.ravel(), w.ravel()], -1)

    child_flat = child.reshape(-1)
    for level in range(D):
        cell_f = F // (N ** (level + 1))
        n = len(nodes)
        all_nodes = np.repeat(nodes, N ** 3)
        all_corners = np.repeat(corners, N ** 3, axis=0) + np.tile(uvw, (n, 1)) * cell_f
        tiled_uvw = np.tile(uvw, (n, 1))
        flat = (
            (all_nodes * N + tiled_uvw[:, 0]) * N + tiled_uvw[:, 1]
        ) * N + tiled_uvw[:, 2]
        skips = child_flat[flat]
        is_leaf = skips == 0
        cells_corner.append(all_corners[is_leaf])
        cells_depth.append(np.full(int(is_leaf.sum()), level, np.int64))
        cells_src.append(flat[is_leaf])
        nxt = ~is_leaf
        nodes = all_nodes[nxt] + skips[nxt]
        corners = all_corners[nxt]
        if len(nodes) == 0:
            break

    return (
        np.concatenate(cells_corner),
        np.concatenate(cells_depth),
        np.concatenate(cells_src),
        D,
    )


def _paint(dst, dst_aux, idx3, span, values, depths, srcs, aux3=None):
    """Paint (possibly multi-cell) regions into a dense 3-D grid."""
    for s in np.unique(span):
        m = span == s
        cs = idx3[m]
        packed = values[m]
        dp = depths[m]
        sr = srcs[m]
        if s == 1:
            sel = (cs[:, 0], cs[:, 1], cs[:, 2])
            dst[sel] = packed
            dst_aux[0][sel] = dp
            dst_aux[1][sel] = sr
        else:
            off = np.arange(s)
            ox, oy, oz = np.meshgrid(off, off, off, indexing="ij")
            ox, oy, oz = ox.ravel(), oy.ravel(), oz.ravel()
            rep = int(s ** 3)
            X = (cs[:, 0, None] + ox).ravel()
            Y = (cs[:, 1, None] + oy).ravel()
            Z = (cs[:, 2, None] + oz).ravel()
            dst[X, Y, Z] = np.repeat(packed, rep)
            dst_aux[0][X, Y, Z] = np.repeat(dp, rep)
            dst_aux[1][X, Y, Z] = np.repeat(sr, rep)


def _grow_skip_boxes(rows, corners, depths, N, F):
    """Grow per-empty-leaf guaranteed-empty AABBs; returns packed rows.

    `rows` is the per-leaf packed row array (EMPTY_ROW = no data);
    `corners` the leaf lower corners in finest-grid units, `depths` the
    leaf depths (cell side = F // N^(depth+1) fine cells). Emptiness is
    verified against a summed-area table of the occupied-cell grid, so
    a box never contains a cell with a data pointer; space outside the
    unit cube counts as empty (the global tmax clamp already bounds the
    march there). Each face extent is grown greedily, round-robin, by
    one leaf-size step per round, saturating at _SKIP_EXT_MAX."""
    empty = rows == EMPTY_ROW
    occ = ~empty
    if not (empty.any() and occ.any()):
        return rows
    size = (F // (N ** (depths + 1))).astype(np.int64)

    grid = np.zeros((F, F, F), np.uint8)
    oc = corners[occ]
    osz = size[occ]
    for s in np.unique(osz):
        m = osz == s
        cs = oc[m]
        if s == 1:
            grid[cs[:, 0], cs[:, 1], cs[:, 2]] = 1
        else:
            off = np.arange(s)
            ox, oy, oz = np.meshgrid(off, off, off, indexing="ij")
            ox, oy, oz = ox.ravel(), oy.ravel(), oz.ravel()
            grid[
                (cs[:, 0, None] + ox).ravel(),
                (cs[:, 1, None] + oy).ravel(),
                (cs[:, 2, None] + oz).ravel(),
            ] = 1

    sat = np.zeros((F + 1, F + 1, F + 1), np.int32)
    sat[1:, 1:, 1:] = grid
    np.cumsum(sat, axis=0, out=sat)
    np.cumsum(sat, axis=1, out=sat)
    np.cumsum(sat, axis=2, out=sat)

    def box_count(lo, hi):
        lo = np.clip(lo, 0, F)
        hi = np.clip(hi, 0, F)
        hi = np.maximum(hi, lo)
        x0, y0, z0 = lo[:, 0], lo[:, 1], lo[:, 2]
        x1, y1, z1 = hi[:, 0], hi[:, 1], hi[:, 2]
        return (
            sat[x1, y1, z1] - sat[x0, y1, z1] - sat[x1, y0, z1]
            - sat[x1, y1, z0] + sat[x0, y0, z1] + sat[x0, y1, z0]
            + sat[x1, y0, z0] - sat[x0, y0, z0]
        )

    es = size[empty]
    lo = corners[empty].copy()
    hi = lo + es[:, None]
    E = len(es)
    ext_lo = np.zeros((E, 3), np.int64)
    ext_hi = np.zeros((E, 3), np.int64)
    for _ in range(_SKIP_EXT_MAX):
        grew = False
        for axis in range(3):
            c_lo = lo.copy()
            c_hi = hi.copy()
            c_lo[:, axis] = hi[:, axis]
            c_hi[:, axis] = hi[:, axis] + es
            ok = (box_count(c_lo, c_hi) == 0) & (
                ext_hi[:, axis] < _SKIP_EXT_MAX
            )
            hi[ok, axis] += es[ok]
            ext_hi[ok, axis] += 1
            grew = grew or bool(ok.any())

            c_lo = lo.copy()
            c_hi = hi.copy()
            c_hi[:, axis] = lo[:, axis]
            c_lo[:, axis] = lo[:, axis] - es
            ok = (box_count(c_lo, c_hi) == 0) & (
                ext_lo[:, axis] < _SKIP_EXT_MAX
            )
            lo[ok, axis] -= es[ok]
            ext_lo[ok, axis] += 1
            grew = grew or bool(ok.any())
        if not grew:
            break

    bits = (
        ext_lo[:, 0]
        | (ext_hi[:, 0] << 4)
        | (ext_lo[:, 1] << 8)
        | (ext_hi[:, 1] << 12)
        | (ext_lo[:, 2] << 16)
        | (ext_hi[:, 2] << 20)
    )
    rows = rows.copy()
    rows[empty] = SKIP_BASE + bits
    return rows


def bake_arrays(
    child: np.ndarray,
    data: np.ndarray,
    parent_depth: np.ndarray,
    offset,
    scaling,
    n_internal: int,
    extra_data=None,
    transformation_matrices=None,
    top_levels: Optional[int] = None,
    mid_levels: Optional[int] = None,
    skip_boxes: bool = True,
) -> BakedTree:
    """Bake from host-side (capacity, N, N, N[, 1]) arrays.

    ``skip_boxes``: pack guaranteed-empty skip AABBs into empty cells'
    sentinel lanes (see SKIP_BASE above). On by default — exact-mode
    rendering is unaffected (the empty test is unchanged); only the
    FAST-mode march (RenderOptions.skip_boxes) reads the extents.
    Auto-disabled for very deep trees (fine grid > _SKIP_MAX_FINE^3)
    and for pools whose row ids reach SKIP_BASE."""
    child = np.asarray(child)
    N = child.shape[1]
    data_flat = np.asarray(data).reshape(-1).astype(np.int64)
    parent_depth = np.asarray(parent_depth)

    corners, depths, srcs, D = _leaf_cells(child, parent_depth, n_internal)
    if top_levels is None:
        # Dense top up to 2^21 cells (2^18 for trees of depth >= 9);
        # deeper levels go to bricks. The caps are semantics-free and
        # not yet measured on the GPU (ROADMAP 1.7).
        cap_cells = 2 ** 18 if D >= 9 else 2 ** 21
        top_levels = D
        while (N ** top_levels) ** 3 > cap_cells:
            top_levels -= 1
    top_levels = min(top_levels, D)
    brick_total = D - top_levels
    if mid_levels is None:
        # Fine bricks cube in size with their level count (a 4-level
        # brick is 4096 cells at N=2); very deep trees get a MIDDLE
        # brick stage so each atlas stays O(occupied).
        fine_levels = min(brick_total, 3)
        mid_levels = brick_total - fine_levels
    else:
        mid_levels = max(0, min(int(mid_levels), brick_total))
        fine_levels = brick_total - mid_levels
    brick_levels = fine_levels
    R = N ** top_levels
    M1 = N ** mid_levels
    B = N ** brick_levels
    F = N ** D

    rows = np.minimum(data_flat[srcs], EMPTY_ROW).astype(np.int64)
    rows = np.where(rows < 0, EMPTY_ROW, rows)

    # Occupied-cell AABB in tree coords (see BakedTree.aabb_lo) — must
    # see pre-skip-box rows (boxes re-code empty cells below EMPTY_ROW).
    occ = rows < EMPTY_ROW

    # skip_base marks the CODING as enabled (the march may decode box
    # extents from sentinel lanes) even when there is nothing to grow
    # yet — trees baked before their first `construct_tree` re-point
    # start all-empty, and `grow_boxes_device` adds boxes after refresh.
    skip_base = 0
    if (
        skip_boxes
        and F <= _SKIP_MAX_FINE
        and (not occ.any() or int(rows[occ].max()) < SKIP_BASE)
    ):
        skip_base = SKIP_BASE
        if occ.any() and (~occ).any():
            rows = _grow_skip_boxes(rows, corners, depths, N, F)

    packed = ((depths.astype(np.int64) << ROW_BITS) | rows).astype(np.int64)
    if occ.any():
        size_occ = (F // (N ** (depths[occ] + 1)))[:, None]
        aabb_lo = (corners[occ].min(axis=0) / F).astype(np.float32)
        aabb_hi = ((corners[occ] + size_occ).max(axis=0) / F).astype(np.float32)
    else:
        # no data anywhere: a null box culls every ray (all-background)
        aabb_lo = np.ones(3, np.float32)
        aabb_hi = np.zeros(3, np.float32)

    top = np.full((R, R, R), EMPTY_ROW, np.int64)
    top_depth = np.zeros((R, R, R), np.int64)
    top_src = np.zeros((R, R, R), np.int64)

    top_cell_f = F // R
    corner_top = corners // top_cell_f
    shallow = depths < top_levels
    deep = ~shallow

    span = (R // (N ** (depths[shallow] + 1))).astype(np.int64)
    _paint(
        top,
        (top_depth, top_src),
        corner_top[shallow],
        span,
        packed[shallow],
        depths[shallow],
        srcs[shallow],
    )

    def _paint_bricks(atlas, aux, brick_of, cell_corner, span, pk_v, dp_v,
                      sr_v):
        """Paint (possibly multi-cell) leaf spans into an (n, S, S, S)
        brick atlas; `cell_corner` in atlas-cell units relative to each
        brick's origin."""
        a_depth, a_src = aux
        for s in np.unique(span):
            m = span == s
            bi = brick_of[m]
            cs = cell_corner[m]
            pk = pk_v[m]
            dpv = dp_v[m]
            srv = sr_v[m]
            if s == 1:
                atlas[bi, cs[:, 0], cs[:, 1], cs[:, 2]] = pk
                a_depth[bi, cs[:, 0], cs[:, 1], cs[:, 2]] = dpv
                a_src[bi, cs[:, 0], cs[:, 1], cs[:, 2]] = srv
            else:
                off = np.arange(s)
                ox, oy, oz = np.meshgrid(off, off, off, indexing="ij")
                ox, oy, oz = ox.ravel(), oy.ravel(), oz.ravel()
                rep = int(s ** 3)
                BI = np.repeat(bi, rep)
                X = (cs[:, 0, None] + ox).ravel()
                Y = (cs[:, 1, None] + oy).ravel()
                Z = (cs[:, 2, None] + oz).ravel()
                atlas[BI, X, Y, Z] = np.repeat(pk, rep)
                a_depth[BI, X, Y, Z] = np.repeat(dpv, rep)
                a_src[BI, X, Y, Z] = np.repeat(srv, rep)

    mid = mid_depth = mid_src = None
    brick = brick_depth = brick_src = None
    if mid_levels > 0 and deep.any():
        # Three-stage: top cell -> mid brick; mid cell -> fine brick.
        c_top = corner_top[deep]
        uniq_cells, mid_of = np.unique(
            (c_top[:, 0] * R + c_top[:, 1]) * R + c_top[:, 2],
            return_inverse=True,
        )
        n_mid = len(uniq_cells)
        top.reshape(-1)[uniq_cells] = -(np.arange(n_mid, dtype=np.int64) + 1)
        mid = np.full((n_mid, M1, M1, M1), EMPTY_ROW, np.int64)
        mid_depth = np.zeros((n_mid, M1, M1, M1), np.int64)
        mid_src = np.zeros((n_mid, M1, M1, M1), np.int64)

        mcf = F // (R * M1)  # finest units per mid cell (== B)
        corner_in_top = corners[deep] % top_cell_f
        midc = corner_in_top // mcf
        size_f = (F // (N ** (depths[deep] + 1))).astype(np.int64)

        middle = depths[deep] < top_levels + mid_levels
        if middle.any():
            _paint_bricks(
                mid, (mid_depth, mid_src), mid_of[middle], midc[middle],
                (size_f[middle] // mcf).astype(np.int64),
                packed[deep][middle], depths[deep][middle],
                srcs[deep][middle],
            )
        deep2 = ~middle
        if deep2.any():
            fine_key = (
                mid_of[deep2] * (M1 ** 3)
                + (midc[deep2][:, 0] * M1 + midc[deep2][:, 1]) * M1
                + midc[deep2][:, 2]
            )
            uniq_fine, fine_of = np.unique(fine_key, return_inverse=True)
            n_fine = len(uniq_fine)
            # fine_key doubles as the flat mid-atlas index
            mid.reshape(-1)[uniq_fine] = -(
                np.arange(n_fine, dtype=np.int64) + 1
            )
            brick = np.full((n_fine, B, B, B), EMPTY_ROW, np.int64)
            brick_depth = np.zeros((n_fine, B, B, B), np.int64)
            brick_src = np.zeros((n_fine, B, B, B), np.int64)
            corner_in_mid = corner_in_top[deep2] % mcf
            _paint_bricks(
                brick, (brick_depth, brick_src), fine_of,
                corner_in_mid, size_f[deep2],
                packed[deep][deep2], depths[deep][deep2],
                srcs[deep][deep2],
            )
    elif brick_levels > 0 and deep.any():
        dp_c_top = corner_top[deep]
        uniq_cells, brick_of = np.unique(
            (dp_c_top[:, 0] * R + dp_c_top[:, 1]) * R + dp_c_top[:, 2],
            return_inverse=True,
        )
        n_bricks = len(uniq_cells)
        top.reshape(-1)[uniq_cells] = -(np.arange(n_bricks, dtype=np.int64) + 1)
        brick = np.full((n_bricks, B, B, B), EMPTY_ROW, np.int64)
        brick_depth = np.zeros((n_bricks, B, B, B), np.int64)
        brick_src = np.zeros((n_bricks, B, B, B), np.int64)
        _paint_bricks(
            brick, (brick_depth, brick_src), brick_of,
            corners[deep] % top_cell_f,
            (F // (N ** (depths[deep] + 1))).astype(np.int64),
            packed[deep], depths[deep], srcs[deep],
        )
    if brick is None:
        brick = np.full((1, B, B, B), EMPTY_ROW, np.int64)
        brick_depth = np.zeros((1, B, B, B), np.int64)
        brick_src = np.zeros((1, B, B, B), np.int64)
    if mid_levels > 0 and mid is None:
        mid = np.full((1, M1, M1, M1), EMPTY_ROW, np.int64)
        mid_depth = np.zeros((1, M1, M1, M1), np.int64)
        mid_src = np.zeros((1, M1, M1, M1), np.int64)

    def _width_for(n_cells: int) -> int:
        # keep rows <= MAX_TABLE_ROWS
        w = 8
        while n_cells // w > MAX_TABLE_ROWS and w < 256:
            w *= 2
        return w

    top_width = _width_for(top.size)
    brick_width = _width_for(brick.size)
    mid_width = _width_for(mid.size) if mid is not None else 8

    def _padw(a, fill, w):
        pad = (-len(a)) % w
        if pad:
            a = np.concatenate([a, np.full(pad, fill, a.dtype)])
        return a

    # Pad each segment to its row-gather width (lane selection never
    # picks a padding entry; see _row_gather). Segment order in the
    # src/depth maps (and the cell-id space): [top, mid?, brick].
    top_flat = _padw(top.reshape(-1), EMPTY_ROW, top_width)
    brick_flat = _padw(brick.reshape(-1), EMPTY_ROW, brick_width)
    src_segs = [_padw(top_src.reshape(-1), 0, top_width)]
    depth_segs = [_padw(top_depth.reshape(-1), 0, top_width)]
    if mid is not None:
        mid_flat = _padw(mid.reshape(-1), EMPTY_ROW, mid_width)
        src_segs.append(_padw(mid_src.reshape(-1), 0, mid_width))
        depth_segs.append(_padw(mid_depth.reshape(-1), 0, mid_width))
    src_segs.append(_padw(brick_src.reshape(-1), 0, brick_width))
    depth_segs.append(_padw(brick_depth.reshape(-1), 0, brick_width))
    src_map = np.concatenate(src_segs)
    depth_parts = np.concatenate(depth_segs) << ROW_BITS

    return BakedTree(
        top=jnp.asarray(top_flat.astype(np.int32).reshape(-1, top_width)),
        brick=jnp.asarray(brick_flat.astype(np.int32).reshape(-1, brick_width)),
        mid=None if mid is None else jnp.asarray(
            mid_flat.astype(np.int32).reshape(-1, mid_width)
        ),
        src_map=jnp.asarray(src_map.astype(np.int32)),
        depth_parts=jnp.asarray(depth_parts.astype(np.int32)),
        offset=jnp.asarray(np.asarray(offset), jnp.float32),
        scaling=jnp.asarray(np.asarray(scaling), jnp.float32),
        extra_data=None if extra_data is None else jnp.asarray(extra_data, jnp.float32),
        transformation_matrices=None
        if transformation_matrices is None
        else jnp.asarray(transformation_matrices, jnp.float32),
        N=N,
        top_levels=int(top_levels),
        brick_levels=int(brick_levels),
        mid_levels=int(mid_levels),
        mid_width=int(mid_width),
        n_tree_cells=int(child.size),
        top_width=int(top_width),
        brick_width=int(brick_width),
        skip_base=int(skip_base),
        aabb_lo=jnp.asarray(aabb_lo),
        aabb_hi=jnp.asarray(aabb_hi),
    )


def bake(spec: TreeSpec, top_levels: Optional[int] = None,
         mid_levels: Optional[int] = None,
         skip_boxes: bool = True) -> BakedTree:
    """Bake a device TreeSpec (pulls tables to host first)."""
    N = spec.N
    child = np.asarray(jax.device_get(spec.child_flat)).reshape(-1, N, N, N)
    data = np.asarray(jax.device_get(spec.data_flat))
    pd = np.asarray(jax.device_get(spec.parent_depth))
    return bake_arrays(
        child,
        data,
        pd,
        np.asarray(jax.device_get(spec.offset)),
        np.asarray(jax.device_get(spec.scaling)),
        spec.n_internal,
        extra_data=None if spec.extra_data is None else np.asarray(jax.device_get(spec.extra_data)),
        transformation_matrices=None
        if spec.transformation_matrices is None
        else np.asarray(jax.device_get(spec.transformation_matrices)),
        top_levels=top_levels,
        mid_levels=mid_levels,
        skip_boxes=skip_boxes,
    )


def refresh(baked: BakedTree, data_flat: jax.Array,
            aabb_lo=None, aabb_hi=None) -> BakedTree:
    """On-device re-bake after construct_tree re-pointed the index table
    (structure unchanged): one gather + repack.

    Re-pointing can occupy cells outside the old occupied-AABB, so the
    cull box must be updated: pass the new box (callers with the points
    know it — `N3Tree.construct_tree` passes the union of the old box
    and the points' covering-leaf box); with None the box conservatively
    resets to the full cube (culling off, never wrong)."""
    if baked.brick_axis is not None:
        raise ValueError(
            "refresh() needs the global bake: refresh the unsharded "
            "BakedTree, then re-shard (parallel.shard_baked)"
        )
    n_top = baked.top.size
    rows = jnp.minimum(data_flat[baked.src_map], EMPTY_ROW)
    rows = jnp.where(rows < 0, EMPTY_ROW, rows)
    packed = baked.depth_parts | rows
    new_top = jnp.where(
        baked.top < 0, baked.top, packed[:n_top].reshape(baked.top.shape)
    )
    if (aabb_lo is None) != (aabb_hi is None):
        # A half-specified box would either crash (lo without hi:
        # jnp.asarray(None)) or silently discard the caller's hi.
        raise ValueError("pass both aabb_lo and aabb_hi, or neither")
    if aabb_lo is None:
        aabb_lo = jnp.zeros(3, jnp.float32)
        aabb_hi = jnp.ones(3, jnp.float32)
    updates = {}
    if baked.mid is not None:
        n_mid = baked.mid.size
        updates["mid"] = jnp.where(
            baked.mid < 0,
            baked.mid,
            packed[n_top:n_top + n_mid].reshape(baked.mid.shape),
        )
        updates["brick"] = packed[n_top + n_mid:].reshape(baked.brick.shape)
    else:
        updates["brick"] = packed[n_top:].reshape(baked.brick.shape)
    return dataclasses.replace(
        baked,
        top=new_top,
        aabb_lo=jnp.asarray(aabb_lo),
        aabb_hi=jnp.asarray(aabb_hi),
        **updates,
    )


def grow_boxes_device(baked: BakedTree) -> BakedTree:
    """Re-grow SYMMETRIC skip boxes on device (after `refresh()`).

    `refresh()` re-packs rows from the index table, degrading every
    bake-time skip box to a plain sentinel — correct but slow for
    FAST-mode serving of re-pointed structures (the fused dynamic frame
    loop). This recovers most of the win without leaving the device: an
    iterated 3^3 max-pool (chebyshev dilation) of the occupied-cell
    indicator over the dense TOP grid yields, per cell, the largest e
    such that every cell within chebyshev distance e is empty; each
    empty top cell then packs the symmetric box extent
    floor((e - s + 1) / s) in its own leaf-size units (s = leaf cells
    per top cell), so a leaf's box `leaf corner +- extent*leafsize` is
    guaranteed empty. Space outside the cube counts as empty (same
    license as the host growth; the tmax clamp bounds the march there).
    Cells under brick pointers and all brick cells keep plain sentinels
    (conservative). Occupancy tests `row < SKIP_BASE`, so existing box
    codes read as empty and the operation is idempotent. No-op when the
    bake carries no skip coding (`skip_base == 0`).

    Pure jnp ops on the (R^3,) top table (~15 reduce_windows) — safe
    inside scanned frame loops.
    """
    if not baked.skip_base:
        return baked
    R = baked.R
    N = baked.N
    w = baked.top_width
    top_flat = baked.top.reshape(-1)
    e = top_flat[: R ** 3]
    row = jax.lax.bitwise_and(e, ROW_MASK)
    depth = jax.lax.shift_right_logical(jnp.maximum(e, 0), ROW_BITS)
    is_brick = e < 0
    occupied = jnp.logical_or(is_brick, row < SKIP_BASE)
    empty = jnp.logical_not(occupied)

    occ3 = occupied.reshape(R, R, R)
    dil = occ3
    e_map = jnp.zeros((R, R, R), jnp.int32)
    for _ in range(_SKIP_EXT_MAX):
        dil = jax.lax.reduce_window(
            dil, False, jax.lax.bitwise_or, (3, 3, 3), (1, 1, 1), "SAME"
        )
        e_map = e_map + jnp.logical_not(dil).astype(jnp.int32)
    e_map = e_map.reshape(-1)

    # leaf size in top cells (in-top leaves have depth+1 <= top_levels)
    cube = jnp.power(jnp.int32(N), (depth + 1).astype(jnp.int32))
    s = jnp.maximum(R // jnp.maximum(cube, 1), 1).astype(jnp.int32)
    ext = jnp.clip((e_map - (s - 1)) // s, 0, _SKIP_EXT_MAX)
    bits = ext * jnp.int32(0x111111)  # same extent in all six nibbles
    new_e = jnp.where(
        jnp.logical_and(empty, ext > 0),
        jax.lax.bitwise_and(e, ~ROW_MASK) | (SKIP_BASE + bits),
        e,
    )
    new_flat = jax.lax.dynamic_update_slice(top_flat, new_e, (0,))
    return dataclasses.replace(baked, top=new_flat.reshape(-1, w))


def _row_gather(table2d: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather scalars from a row-packed (rows, width) int32 table.

    Fetch the row containing each element and select the lane with a
    one-hot sum (elementwise work that fuses). The table must
    already be 2-D: reshaping inside a march loop materializes a full
    copy every iteration.
    """
    width = table2d.shape[1]
    if width == 1:
        return table2d[idx, 0]
    shift = width.bit_length() - 1  # log2(width); width is a power of 2
    rows = table2d[idx >> shift]  # (..., width)
    lane = (idx & (width - 1))[..., None]
    oh = (
        jax.lax.broadcasted_iota(jnp.int32, rows.shape, rows.ndim - 1) == lane
    )
    return jnp.sum(jnp.where(oh, rows, 0), axis=-1)


def _brick_gather(baked: BakedTree, idx: jax.Array) -> jax.Array:
    """Brick-table gather, shard-aware (see BakedTree.brick_axis)."""
    if baked.brick_axis is None:
        return _row_gather(baked.brick, idx)
    n_elem = baked.brick.size  # this shard's element count
    elem0 = jax.lax.axis_index(baked.brick_axis).astype(jnp.int32) * n_elem
    loc = idx - elem0
    own = jnp.logical_and(loc >= 0, loc < n_elem)
    v = _row_gather(baked.brick, jnp.where(own, loc, 0))
    return jax.lax.psum(jnp.where(own, v, 0), baked.brick_axis)


def _descend_chain(p, N: int, D: int):
    """Iterated per-level descent arithmetic, bit-parity with
    ``ops.traversal.descend``: scale by N, floor, keep the remainder, D
    times. Returns ``(g, fracs)`` — the finest-grid cell index (int32,
    exactly the cell descend's per-level floors select) and the list of
    in-leaf fractions ``fracs[d]`` for a leaf at depth ``d`` (d+1 levels
    applied). Elementwise over any shape.

    Needed when N is NOT a power of two: a one-shot float product
    ``p * N**k`` rounds ONCE where the reference's chain (common.cuh:
    76-97) rounds per level, so fractions differ by ~1 ulp almost
    everywhere (measured 89% of uniform points at N=3, depth 4) and the
    march's sequential t-chain amplifies that into visible radiometric
    drift. For power-of-two N every step is exact and the one-shot form
    is bit-identical — callers keep the cheaper path there.
    """
    x = p
    g = jnp.zeros(jnp.shape(p), jnp.int32)
    fracs = []
    for _ in range(D):
        xs = x * N
        u = jnp.minimum(jnp.floor(xs), N - 1).astype(jnp.int32)
        x = xs - u
        g = g * N + u
        fracs.append(x)
    return g, fracs


def _select_by_depth(vals, depth_eq):
    """``vals[d]`` per element, as a where-chain (no gather): ``vals`` is
    a static list indexed by depth, ``depth_eq(i)`` a broadcastable
    boolean mask for depth == i."""
    acc = vals[0]
    for i in range(1, len(vals)):
        acc = jnp.where(depth_eq(i), vals[i], acc)
    return acc


def _cube_consts(N: int, D: int, dtype):
    """Static ``N**(d+1)`` leaf resolutions for depths 0..D-1. Exact (and
    equal to descend's iterated float product) while N**D < 2**24."""
    return [jnp.asarray(float(N ** (d + 1)), dtype) for d in range(D)]


def lookup_xyz(baked: BakedTree, px, py, pz):
    """`lookup` on unstacked per-axis coordinates — pure elementwise math
    around the row gathers, so XLA fuses each march step into a couple of
    kernels (stacked (B,3) forms force cross-axis slice/reduce ops that
    break fusion).

    :return: (data_idx, cube_sz, fx, fy, fz, cell_id) — per-axis in-leaf
        fractions instead of the stacked `frac`.

    For power-of-two N the fractions come from a one-shot float product
    (p * cube_sz) — bit-identical to descend's per-level chain because
    scaling by 2**k and subtracting the integer part are exact. For any
    other N the one-shot product rounds differently than the chain, so
    fractions, cube sizes, and the structure floor all come from
    ``_descend_chain`` — bit-parity with the tree backend everywhere.
    """
    N = baked.N
    R = baked.R
    Bk = baked.B
    n_top = baked.top.size
    one = 1.0 - 1e-6
    px = jnp.clip(px, 0.0, one)
    py = jnp.clip(py, 0.0, one)
    pz = jnp.clip(pz, 0.0, one)

    # All stage indices derive from ONE finest-grid floor per axis
    # (integer division up the stages). Independent per-stage float
    # products can disagree at cell boundaries for non-power-of-two N
    # (px*R rounding up across a cell while px*R*Bk rounds down), which
    # would wrap the subcell (mod Bk) into the WRONG end of a brick —
    # the same one-shot-float hazard ops/query.py avoids for N != 2.
    if baked.mid_levels > 0:
        M1 = baked.M1
        G, stage1 = R * M1 * Bk, M1 * Bk
    elif baked.brick_levels > 0:
        G, stage1 = R * Bk, Bk
    else:
        G, stage1 = R, 1
    D = baked.top_levels + baked.mid_levels + baked.brick_levels
    if N & (N - 1):  # non-power-of-two: exact per-level chain
        gx, frx = _descend_chain(px, N, D)
        gy, fry = _descend_chain(py, N, D)
        gz, frz = _descend_chain(pz, N, D)
    else:
        frx = fry = frz = None
        gx = jnp.minimum((px * G).astype(jnp.int32), G - 1)
        gy = jnp.minimum((py * G).astype(jnp.int32), G - 1)
        gz = jnp.minimum((pz * G).astype(jnp.int32), G - 1)
    if stage1 > 1:
        cx, cy, cz = gx // stage1, gy // stage1, gz // stage1
    else:
        cx, cy, cz = gx, gy, gz
    top_idx = (cx * R + cy) * R + cz
    e = _row_gather(baked.top, top_idx)

    if baked.mid_levels > 0:
        # Three-stage: top < 0 -> mid brick; mid < 0 -> fine brick.
        n_mid = baked.mid.size
        in_mid = e < 0
        mbid = -e - 1
        mx, my, mz = (gx // Bk) % M1, (gy // Bk) % M1, (gz // Bk) % M1
        m_idx = ((jnp.maximum(mbid, 0) * M1 + mx) * M1 + my) * M1 + mz
        me = _row_gather(baked.mid, m_idx)
        e = jnp.where(in_mid, me, e)
        cell_id = jnp.where(in_mid, n_top + m_idx, top_idx)
        in_fine = e < 0  # only reachable through a mid pointer
        fbid = -e - 1
        fx, fy, fz = gx % Bk, gy % Bk, gz % Bk
        f_idx = ((jnp.maximum(fbid, 0) * Bk + fx) * Bk + fy) * Bk + fz
        fe = _brick_gather(baked, f_idx)
        e = jnp.where(in_fine, fe, e)
        cell_id = jnp.where(in_fine, n_top + n_mid + f_idx, cell_id)
    elif baked.brick_levels > 0:
        in_brick = e < 0
        bid = -e - 1
        sx, sy, sz = gx % Bk, gy % Bk, gz % Bk
        b_idx = ((jnp.maximum(bid, 0) * Bk + sx) * Bk + sy) * Bk + sz
        be = _brick_gather(baked, b_idx)
        e = jnp.where(in_brick, be, e)
        cell_id = jnp.where(in_brick, n_top + b_idx, top_idx)
    else:
        cell_id = top_idx

    depth = jax.lax.shift_right_logical(e, ROW_BITS)
    data_idx = jax.lax.bitwise_and(e, ROW_MASK)
    dtype = px.dtype
    if frx is not None:
        eq = lambda i: depth == i
        cube_sz = jnp.broadcast_to(
            _select_by_depth(_cube_consts(N, D, dtype), eq), depth.shape
        )
        return (
            data_idx,
            cube_sz,
            _select_by_depth(frx, eq),
            _select_by_depth(fry, eq),
            _select_by_depth(frz, eq),
            cell_id,
        )
    # N is a power of two here: exp2 of an integer exponent is exact
    # (float pow is not guaranteed to be, even for exact results).
    cube_sz = jnp.exp2(((depth + 1) * (N.bit_length() - 1)).astype(dtype))
    sx = px * cube_sz
    sy = py * cube_sz
    sz = pz * cube_sz
    return (
        data_idx,
        cube_sz,
        sx - jnp.floor(sx),
        sy - jnp.floor(sy),
        sz - jnp.floor(sz),
        cell_id,
    )


def lookup(baked: BakedTree, pos: jax.Array):
    """Locate leaves for (B, 3) tree-space points — 2 gathers.

    :return: (data_idx (B,), cube_sz (B,), frac (B,3), cell_id (B,))
        with cube_sz/frac semantics matching ops.traversal.descend
        (cube_sz = N^(depth+1)); cell_id is the global baked-cell index
        (top cells first, then brick atlas) usable with ``src_map``.
    """
    N = baked.N
    R = baked.R
    Bk = baked.B
    n_top = baked.top.size
    pos = jnp.clip(pos, 0.0, 1.0 - 1e-6)

    # One finest-grid floor per axis; stage indices by integer division
    # (see lookup_xyz: independent per-stage float products can wrap the
    # brick subcell at cell boundaries for non-power-of-two N).
    if baked.mid_levels > 0:
        G = R * baked.M1 * Bk
    elif baked.brick_levels > 0:
        G = R * Bk
    else:
        G = R
    D = baked.top_levels + baked.mid_levels + baked.brick_levels
    if N & (N - 1):  # non-power-of-two: exact per-level chain (lookup_xyz)
        g, fracs = _descend_chain(pos, N, D)
    else:
        fracs = None
        g = jnp.minimum((pos * G).astype(jnp.int32), G - 1)
    cell = g // (G // R)
    top_idx = (cell[:, 0] * R + cell[:, 1]) * R + cell[:, 2]
    e = _row_gather(baked.top, top_idx)

    if baked.mid_levels > 0:
        M1 = baked.M1
        n_mid = baked.mid.size
        in_mid = e < 0
        mbid = -e - 1
        msub = (g // Bk) % M1
        m_idx = (
            (jnp.maximum(mbid, 0) * M1 + msub[:, 0]) * M1 + msub[:, 1]
        ) * M1 + msub[:, 2]
        me = _row_gather(baked.mid, m_idx)
        e = jnp.where(in_mid, me, e)
        cell_id = jnp.where(in_mid, n_top + m_idx, top_idx)
        in_fine = e < 0
        fbid = -e - 1
        fsub = g % Bk
        f_idx = (
            (jnp.maximum(fbid, 0) * Bk + fsub[:, 0]) * Bk + fsub[:, 1]
        ) * Bk + fsub[:, 2]
        fe = _brick_gather(baked, f_idx)
        e = jnp.where(in_fine, fe, e)
        cell_id = jnp.where(in_fine, n_top + n_mid + f_idx, cell_id)
    elif baked.brick_levels > 0:
        in_brick = e < 0
        bid = -e - 1
        sub = g % Bk
        b_idx = (
            (jnp.maximum(bid, 0) * Bk + sub[:, 0]) * Bk + sub[:, 1]
        ) * Bk + sub[:, 2]
        be = _brick_gather(baked, b_idx)
        e = jnp.where(in_brick, be, e)
        cell_id = jnp.where(in_brick, n_top + b_idx, top_idx)
    else:
        cell_id = top_idx

    depth = jax.lax.shift_right_logical(e, ROW_BITS)
    data_idx = jax.lax.bitwise_and(e, ROW_MASK)
    if fracs is not None:
        cube_sz = jnp.broadcast_to(
            _select_by_depth(_cube_consts(N, D, pos.dtype), lambda i: depth == i),
            depth.shape,
        )
        frac = _select_by_depth(fracs, lambda i: (depth == i)[:, None])
        return data_idx, cube_sz, frac, cell_id
    cube_sz = jnp.exp2(((depth + 1) * (N.bit_length() - 1)).astype(pos.dtype))
    scaled = pos * cube_sz[:, None]
    frac = scaled - jnp.floor(scaled)
    return data_idx, cube_sz, frac, cell_id
