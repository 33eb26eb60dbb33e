"""Batched, vectorized octree traversal — the replacement for the
reference's per-thread pointer chase.

The reference descends the tree per CUDA thread with a data-dependent
`while` over relative child offsets (`query_single_from_root`,
svox_t/csrc/include/common.cuh:62-100). Here that irregular walk becomes
a **fixed-trip-count loop of batched gathers**: every level multiplies all
query coordinates by N, computes flat cell indices, and gathers the child
offset table once for the whole batch. Finished rays are carried through
with masks. `n_levels` is static (tree depth + slack), so XLA compiles a
single fused loop with large coalesced gathers.

Semantics parity (bit-careful):
  * coords clamped to [0, 1 - 1e-6] (common.cuh:38-42);
  * in-leaf fractional coords are post-multiply (the reference mutates
    xyz before the leaf check);
  * cube_sz starts at N and multiplies by N per *continued* level
    (common.cuh:76-97), so a depth-d leaf has cube_sz = N^(d+1);
  * packed node id = ((node * N + u) * N + v) * N + w (common.cuh:90-93).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.spec import TreeSpec


class LeafInfo(NamedTuple):
    data_idx: jax.Array   # (B,) int32 feature-pool row (>= n_features: empty)
    node_flat: jax.Array  # (B,) int32 packed leaf cell id (index into flat tables)
    cube_sz: jax.Array    # (B,) float32 N^(depth+1) of the leaf
    frac: jax.Array       # (B, 3) float32 in-leaf fractional coords


def world2tree(pos: jax.Array, offset: jax.Array, scaling: jax.Array) -> jax.Array:
    """World -> tree [0,1]^3 (parity: common.cuh:45-51)."""
    return offset + scaling * pos


def tree2world(pos: jax.Array, offset: jax.Array, scaling: jax.Array) -> jax.Array:
    """Tree [0,1]^3 -> world (parity: common.cuh:54-60)."""
    return (pos - offset) / scaling


def clamp_coord(pos: jax.Array) -> jax.Array:
    """Clamp to [0, 1 - 1e-6] (parity: common.cuh:38-42)."""
    return jnp.clip(pos, 0.0, 1.0 - 1e-6)


def descend(spec: TreeSpec, pos: jax.Array, with_cell: bool = False):
    """Root-to-leaf descent for a batch of tree-space points.

    :param pos: (B, 3) float32 in [0,1]^3 (will be clamped).
    :param with_cell: also return the integer leaf cell coordinates
        (B, 3) int32 at each point's own leaf resolution ``cube_sz`` —
        the EXACT cell the descent selected (``floor(pos * cube_sz)``
        recomputed one-shot in float can land one cell off near
        boundaries when N is not a power of two).
    :return: LeafInfo over the batch (``(LeafInfo, cell)`` if
        ``with_cell``).
    """
    N = spec.N
    n_levels = spec.n_levels
    child = spec.child_flat
    B = pos.shape[0]
    dtype = pos.dtype

    xyz0 = clamp_coord(pos)

    def body(_, state):
        xyz, node, cube, done, leaf_flat, cell = state
        xyz_s = xyz * N
        uvw = jnp.minimum(jnp.floor(xyz_s), N - 1).astype(jnp.int32)
        frac = xyz_s - uvw
        flat = ((node * N + uvw[:, 0]) * N + uvw[:, 1]) * N + uvw[:, 2]
        skip = child[flat]
        term = jnp.logical_and(skip == 0, jnp.logical_not(done))
        cont = jnp.logical_not(jnp.logical_or(done, term))
        leaf_flat = jnp.where(term, flat, leaf_flat)
        cell = jnp.where(done[:, None], cell, cell * N + uvw)
        xyz = jnp.where(done[:, None], xyz, frac)
        node = jnp.where(cont, node + skip, node)
        cube = jnp.where(cont, cube * N, cube)
        done = jnp.logical_or(done, term)
        return xyz, node, cube, done, leaf_flat, cell

    from .render import _pvary_like

    state = (
        xyz0,
        _pvary_like(jnp.zeros((B,), jnp.int32), xyz0),
        _pvary_like(jnp.full((B,), float(N), dtype), xyz0),
        _pvary_like(jnp.zeros((B,), bool), xyz0),
        _pvary_like(jnp.zeros((B,), jnp.int32), xyz0),
        _pvary_like(jnp.zeros((B, 3), jnp.int32), xyz0),
    )
    xyz, node, cube, done, leaf_flat, cell = jax.lax.fori_loop(
        0, n_levels, body, state, unroll=True
    )
    data_idx = spec.data_flat[leaf_flat]
    leaf = LeafInfo(data_idx=data_idx, node_flat=leaf_flat, cube_sz=cube, frac=xyz)
    return (leaf, cell) if with_cell else leaf


def dda_unit(cen: jax.Array, invdir: jax.Array):
    """Entry/exit of a ray with the unit cube (parity: rt_kernel.cu:201-218).

    :param cen: (..., 3) ray position
    :param invdir: (..., 3) reciprocal direction
    :return: (tmin >= 0, tmax) each (...,)
    """
    t1 = -cen * invdir
    t2 = t1 + invdir
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return jnp.maximum(tmin, 0.0), jnp.minimum(tmax, 1e9)


def get_delta_scale(scaling: jax.Array, dirs: jax.Array):
    """Scale dirs into tree space and normalize (rt_kernel.cu:187-199).

    :return: (unit tree-space dirs (..., 3), delta_scale (...,))
    """
    d = dirs * scaling
    norm = jnp.linalg.norm(d, axis=-1, keepdims=True)
    delta_scale = 1.0 / norm[..., 0]
    return d * delta_scale[..., None], delta_scale


def pack_index(txyz: jax.Array, N: int) -> jax.Array:
    """(Q,4) [node,x,y,z] -> packed id (parity: svox.py:829-831)."""
    return ((txyz[:, 0] * N + txyz[:, 1]) * N + txyz[:, 2]) * N + txyz[:, 3]


def unpack_index(flat: jax.Array, N: int) -> jax.Array:
    """packed id -> (Q,4) [node,x,y,z] (parity: svox.py:833-838)."""
    z = flat % N
    flat = flat // N
    y = flat % N
    flat = flat // N
    x = flat % N
    node = flat // N
    return jnp.stack([node, x, y, z], axis=-1)
