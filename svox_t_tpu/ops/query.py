"""Point query / assignment / tree (re)pointing ops.

Batched equivalents of the reference's `svox_t/csrc/svox_kernel.cu`:
  * `query_vertical` (K1, svox_kernel.cu:66-81, 274-324): differentiable
    batched point query — descend, gather feature rows; custom_vjp
    scatter-adds output grads into the feature pool rows
    (`query_vertical_backward`, svox_kernel.cu:83-94).
  * `assign_vertical` (K3, svox_kernel.cu:96-108): write values into
    feature rows addressed by point descent (functional: returns the new
    feature pool).
  * `construct_tree` (K4, svox_kernel.cu:110-121): real-time octree
    (re)pointing — write each point's row id into its leaf's index slot.
    This is the per-frame "attach this frame's point cloud" op; here it
    is a single batched descent + scatter, entirely on device.
  * `calc_corners` (K5, svox_kernel.cu:213-237): leaf lower corners by
    walking `parent_depth` up to the root. (The reference's CUDA path is
    broken by a dtype dispatch bug — SURVEY.md K5; this one works.)

The reference's hit-leaf mask compaction (svox_kernel.cu:239-269) used a
device→host sync (`num_hit.item()`, svox_kernel.cu:312) to size its
output. The equivalent here is `unique_leaf_nodes`: a fixed-capacity
on-device sort/unique compaction returning a padded list + count —
jittable, deterministic (sorted, unlike the reference's atomic-counter
ordering), no host round-trip.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..utils.spec import TreeSpec
from .render import _zero_cotangent
from .traversal import descend, unpack_index, world2tree


def _descend_points(spec: TreeSpec, points: jax.Array, world: bool):
    pos = world2tree(points, spec.offset, spec.scaling) if world else points
    return descend(spec, pos)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def query(spec: TreeSpec, features: jax.Array, points: jax.Array, world: bool = True):
    """Differentiable point query (parity: N3Tree.forward, svox.py:216-285).

    :param points: (Q, 3) float32 query points.
    :return: (values (Q, D), node_ids (Q,) packed leaf ids,
              data_ids (Q,) feature rows — sentinel >= n_features if empty)

    Empty leaves return zero values (the reference returns uninitialized
    memory there — svox_kernel.cu:282; zeros are the sane upgrade).
    """
    return _query_impl(spec, features, points, world)


def _query_impl(spec, features, points, world):
    leaf = _descend_points(spec, points, world)
    M, D = features.shape
    if M == 0:
        values = jnp.zeros((points.shape[0], D), features.dtype)
        return values, leaf.node_flat, leaf.data_idx
    valid = leaf.data_idx < M
    idx = jnp.where(valid, leaf.data_idx, 0)
    values = jnp.where(valid[:, None], features[idx], 0.0)
    return values, leaf.node_flat, leaf.data_idx


def _query_fwd(spec, features, points, world):
    out = _query_impl(spec, features, points, world)
    return out, (spec, features.shape, points)


def _query_bwd(world, res, g):
    spec, feat_shape, points = res
    g_values = g[0]
    M, D = feat_shape
    leaf = _descend_points(spec, points, world)
    valid = leaf.data_idx < M
    scat = jnp.where(valid, leaf.data_idx, M)
    grad_features = (
        jnp.zeros((M, D), g_values.dtype).at[scat].add(g_values, mode="drop")
    )
    return (_zero_cotangent(spec), grad_features, jnp.zeros_like(points))


query.defvjp(_query_fwd, _query_bwd)


def unique_leaf_nodes(node_ids: jax.Array, N: int, size: int = None):
    """On-device unique hit-leaf compaction (parity: the
    generate_index/unpack_mask kernel pair, svox_kernel.cu:239-269, 312).

    :param node_ids: (Q,) packed leaf ids from `query`.
    :param N: tree branching factor (for unpacking).
    :param size: static output capacity (default Q — always enough).
    :return: (leaf_node (size, 4) int32 [node, x, y, z] sorted by packed
        id and padded with -1 rows, count () int32). Jittable: the padded
        output has a static shape; slice with `count` outside jit.
    """
    Q = node_ids.shape[0]
    if size is None:
        size = Q
    uniq = jnp.unique(node_ids, size=size, fill_value=-1)
    count = jnp.sum(uniq >= 0).astype(jnp.int32)
    leaf = unpack_index(uniq, N)
    return jnp.where(uniq[:, None] >= 0, leaf, -1), count


def assign(
    spec: TreeSpec,
    features: jax.Array,
    points: jax.Array,
    values: jax.Array,
    world: bool = True,
) -> jax.Array:
    """Write `values` into the feature rows addressed by `points`
    (parity: assign_vertical, svox_kernel.cu:96-108). Returns the new
    feature pool. A row addressed by several points takes the write of
    the highest-indexed one (the CUDA kernel races; this is fixed on
    every backend — see `construct_tree`)."""
    leaf = _descend_points(spec, points, world)
    M = features.shape[0]
    valid = leaf.data_idx < M
    scat = jnp.where(valid, leaf.data_idx, M)
    pid = jnp.arange(points.shape[0], dtype=jnp.int32)
    win = jnp.full((M,), -1, jnp.int32).at[scat].max(pid, mode="drop")
    values = jnp.broadcast_to(jnp.asarray(values, features.dtype),
                              (points.shape[0],) + features.shape[1:])
    return jnp.where((win >= 0)[:, None], values[jnp.maximum(win, 0)],
                     features)


def construct_tree(spec: TreeSpec, points: jax.Array) -> jax.Array:
    """Point the tree's leaf index slots at this frame's point rows
    (parity: construct_tree, svox_kernel.cu:110-121).

    :param points: (Q, 3) world-space points; point i's leaf gets index i.
    :return: new flat data table (capacity * N^3,) int32.

    A leaf holding several points gets the highest index among them —
    what a sequential loop leaves behind. A plain scatter-set would
    leave the choice to the backend: XLA:GPU writes duplicates in no
    fixed order, so two programs re-pointing the same frame (the fused
    loop and the dynamic tape) disagreed on the data row.
    """
    leaf = _descend_points(spec, points, True)
    tids = jnp.arange(points.shape[0], dtype=jnp.int32)
    win = jnp.full(spec.data_flat.shape, -1, jnp.int32).at[
        leaf.node_flat].max(tids)
    return jnp.where(win >= 0, win, spec.data_flat).astype(
        spec.data_flat.dtype)


def points_leaf_aabb(spec: TreeSpec, points: jax.Array, world: bool = True):
    """Tree-space AABB of the leaf cells covering `points` — the tight
    occupied box after `construct_tree` points the tree at them (used to
    keep the baked render structure's exact ray-cull box up to date).

    :return: (lo (3,), hi (3,)) float32 device arrays.
    """
    pos = world2tree(points, spec.offset, spec.scaling) if world else points
    leaf, cell = descend(spec, pos, with_cell=True)
    # Use the descent's OWN integer cell: recomputing floor(pos * cube_sz)
    # one-shot in float disagrees with the iterative descent near cell
    # boundaries when N is not a power of two (measured ~8% of boundary
    # points at N=3 depth 5), which would let the cull box exclude the
    # very leaf construct_tree pointed at. Dilated by 1e-6 (the coord
    # clamp epsilon) to absorb the /cube_sz rounding for non-pow2 N —
    # the cull contract is conservative-containment, not tightness.
    cs = leaf.cube_sz[:, None]
    lo_cells = cell.astype(jnp.float32) / cs - 1e-6
    hi_cells = (cell + 1).astype(jnp.float32) / cs + 1e-6
    return (
        jnp.min(lo_cells, axis=0).astype(jnp.float32),
        jnp.max(hi_cells, axis=0).astype(jnp.float32),
    )


def calc_corners(spec: TreeSpec, indexer: jax.Array) -> jax.Array:
    """Lower corner of leaf cells in tree coords [0,1]^3
    (parity: calc_corner_kernel, svox_kernel.cu:213-237).

    :param indexer: (Q, 4) int32 [internal node id, x, y, z]
    :return: (Q, 3) float32
    """
    N = spec.N
    Q = indexer.shape[0]
    parent_packed = spec.parent_depth[:, 0]

    def body(_, state):
        curr, out, done = state
        xyz = curr[:, 1:].astype(jnp.float32)
        out = jnp.where(done[:, None], out, (out + xyz) / N)
        at_root = curr[:, 0] == 0
        nxt = unpack_index(parent_packed[jnp.clip(curr[:, 0], 0, None)], N)
        curr = jnp.where((done | at_root)[:, None], curr, nxt)
        done = done | at_root
        return curr, out, done

    state = (
        indexer.astype(jnp.int32),
        jnp.zeros((Q, 3), jnp.float32),
        jnp.zeros((Q,), bool),
    )
    _, out, _ = jax.lax.fori_loop(0, spec.n_levels + 1, body, state)
    return out
