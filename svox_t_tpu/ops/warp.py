"""Linear-blend-skinning vertex warping — pure JAX, autodiff gradients.

Batched replacement for the reference CUDA LBS kernels
(`warp_vertices_kernel` svox_kernel.cu:123-154 and its hand-written
backward 156-211). The blend is a batched einsum; JAX
autodiff reproduces the reference's analytic gradients exactly (the
backward kernel computes M^T g for coordinates and weighted outer
products for matrices/weights — which *is* the autodiff of this einsum),
so no custom kernel is needed.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .sh import _PREC


def get_transformation_matrix(src_pose: jax.Array, tgt_pose: jax.Array) -> jax.Array:
    """Relative bone transforms `tgt @ inv(src)` (parity: svox.py:971-972)."""
    return jnp.matmul(tgt_pose, jnp.linalg.inv(src_pose), precision=_PREC)


def blend_transformation_matrix(
    transformation_matrix: jax.Array,
    skinning_weights: jax.Array,
    joint_index: jax.Array,
) -> jax.Array:
    """Blend per-joint 4x4 transforms by skinning weights
    (parity: svox.py:978-981 / svox_kernel.cu:139-148).

    Only rows 0..2 are blended; row 3 is [0,0,0,1]. Non-positive skinning
    weights are skipped (treated as 0).

    :param transformation_matrix: (J, 4, 4)
    :param skinning_weights: (Q, n_bones)
    :param joint_index: (Q, n_bones) int
    :return: (Q, 4, 4)
    """
    Q = skinning_weights.shape[0]
    w = jnp.where(skinning_weights > 0, skinning_weights, 0.0)
    gathered = transformation_matrix[joint_index][:, :, :3, :]  # (Q, nb, 3, 4)
    top = jnp.einsum("qb,qbmn->qmn", w, gathered, precision=_PREC)  # (Q, 3, 4)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], top.dtype), (Q, 1, 4)
    )
    return jnp.concatenate([top, bottom], axis=1)


def warp_vertices(
    transformation_matrix: jax.Array,
    coordinates: jax.Array,
    skinning_weights: jax.Array,
    joint_index: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """LBS-warp a point cloud (parity: svox.py:974-976 /
    svox_kernel.cu:123-154). Differentiable wrt transforms, coordinates
    and skinning weights via autodiff.

    :param transformation_matrix: (J, 4, 4) per-joint transforms
    :param coordinates: (Q, 3) canonical points
    :param skinning_weights: (Q, n_bones)
    :param joint_index: (Q, n_bones) int
    :return: (warped (Q, 3), blended matrices (Q, 4, 4))
    """
    m = blend_transformation_matrix(
        transformation_matrix, skinning_weights, joint_index
    )
    warped = (
        jnp.einsum("qij,qj->qi", m[:, :3, :3], coordinates, precision=_PREC)
        + m[:, :3, 3]
    )
    return warped, m
