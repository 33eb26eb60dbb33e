"""Immutable pytree specs marshaled into the jitted render/query ops.

These play the role of the reference's pybind11 spec structs
(`svox_t/csrc/include/data_spec.hpp:52-145`: ``TreeSpec``, ``RaysSpec``,
``CameraSpec``, ``RenderOptions``) — but instead of host-side POD structs
handed to CUDA launchers, they are JAX pytrees (array leaves traced under
`jit`) with hashable static metadata, so one compiled executable is reused
across frames as long as shapes/format stay fixed.

Design notes:
  * ``child``/``data`` are stored **flattened** to 1-D ``(capacity * N^3,)``
    so octree descent is a pure batched gather with precomputed flat
    indices — no 4-D indexing in the hot loop.
  * ``n_levels`` (max descent iterations) is static metadata so the
    traversal loop has a fixed trip count (XLA requires static bounds).
  * The empty-leaf sentinel is any ``data`` entry >= features.shape[0]
    (the reference initializes the index table with ``int32(1e10)`` =
    1410065408 after wraparound; svox_t/svox.py:123-124). We keep the
    same sentinel value for .npz compatibility.
"""

from __future__ import annotations

import dataclasses
from collections import namedtuple
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

# Empty-leaf sentinel: int32 wraparound of 1e10, matching the reference's
# `torch.ones(...) * int(1e10)` int32 buffer init (svox_t/svox.py:123-124).
DATA_SENTINEL = np.int32(np.uint64(10_000_000_000) & 0xFFFFFFFF)  # 1410065408

NDCConfig = namedtuple("NDCConfig", ["width", "height", "focal"])
Rays = namedtuple("Rays", ["origins", "dirs", "viewdirs"])

# Format codes mirror DataFormat (utils/dataformat.py).
FORMAT_RGBA = 0
FORMAT_SH = 1
FORMAT_SG = 2
FORMAT_ASG = 3


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Static render configuration (parity: data_spec.hpp:129-145).

    Hashable & frozen: passed as a static argument to jitted render ops.
    """

    step_size: float = 1e-3
    background_brightness: float = 1.0
    format: int = FORMAT_RGBA
    basis_dim: int = -1
    ndc_width: int = -1
    ndc_height: int = -1
    ndc_focal: float = -1.0
    min_comp: int = 0
    max_comp: int = -1
    sigma_thresh: float = 0.0
    stop_thresh: float = 0.0
    # Static bound on march iterations (the reference's
    # while(t < tmax) has a data-dependent trip count; XLA wants a bound).
    # delta_t >= step_size so the march is guaranteed to terminate in
    # ~sqrt(3)/step_size steps; leaf-adaptive stepping makes the practical
    # count far smaller. 1024 covers depth<=9 trees comfortably.
    max_steps: int = 1024
    # Rays are marched in chunks of this size, each chunk's loop
    # exiting as soon as its own rays are done. The batch-synchronous
    # alternative pays the slowest ray's step count for every ray.
    # <= 0 disables chunking. The default is not yet measured on the
    # GPU (ROADMAP 1.7).
    chunk_size: int = 1024
    # Samples marched per while-loop iteration ("round").
    # Phase 1 of a round performs `round_size` dependent structure
    # lookups (the only truly sequential work); phase 2 computes all
    # radiometry for the round vectorized. Larger rounds amortize loop
    # plumbing (cond reduction, carry copies) but waste up to
    # round_size-1 samples on rays that finish mid-round. The default
    # is not yet measured on the GPU (ROADMAP 1.7).
    round_size: int = 4
    # 0 = nearest-leaf-constant sampling (reference semantics);
    # 1 = per-sample trilinear feature interpolation over the 8
    # neighboring cells of the leaf's own resolution grid (the north-star
    # option; ~8x gather cost — opt-in). Empty neighbors contribute 0.
    interp: int = 0
    # FAST-MODE-ONLY empty-space acceleration: advance each ray's start t
    # to its entry into the baked occupied-cell AABB (skipping the
    # provably-empty approach). Samples before the box contribute nothing,
    # but removing them SHIFTS every subsequent sample position on the
    # sequential t-chain, so outputs change by O(step_size * sigma) —
    # the same accuracy license as the reference's fast thresholds
    # (renderer.py:428-433). MUST stay 0 on the exact-parity path; no-op
    # for tree-walk specs (no box) and under interp.
    box_advance: int = 0
    # FAST-MODE-ONLY directed empty-space skip: when the baked structure
    # carries per-empty-leaf skip boxes (BakedTree.skip_base, packed into
    # the sentinel lane the march already fetches — zero extra gathers),
    # empty samples advance to the exit of a guaranteed-empty AABB
    # instead of the single cell. Empty samples contribute nothing, but
    # merging their crossings SHIFTS later sample positions on the
    # sequential t-chain by up to step_size per merged run — the same
    # accuracy license as box_advance / the reference's fast thresholds.
    # MUST stay 0 on the exact-parity path; no-op for tree-walk specs,
    # box-free bakes, and under interp (boxes are not skin-eroded).
    skip_boxes: int = 0
    # Reference-quirk compatibility for motion_render's hit point: the
    # reference's query_single_from_root destructively rewrites `pos`
    # to the in-leaf FRACTIONAL coordinate (common.cuh:77-87) before
    # rt_kernel.cu:756-774 world-transforms it, so its "world hit
    # point" — and the joint distances derived from it — are computed
    # from leaf-local fractions. Default 0 reports the actual sample
    # position (the sensible semantics); 1 reproduces the quirk for
    # drop-in parity with Artemis models TRAINED against it.
    compat_hit_point: int = 0
    # Backward gradient-tape capacity (rows). 0 = per-round tiered
    # scatter (each round pays a latency-chained scatter call). > 0 =
    # per-round COMPACT-APPEND of contributing gradient rows into a
    # global (grad_tape_rows, D) tape carried across chunks, with ONE
    # bulk scatter at the end.
    # Overflowing rounds fall back to the tiered scatter, so any
    # capacity is CORRECT; size it ~= expected contributing samples.
    # Exact single-pass nearest-mode backward only (interp/thresholded
    # paths ignore it).
    grad_tape_rows: int = 0
    # TAPE-backward scatter strategy (ops/tape.py only). 1 (default) =
    # emit each round's gradient rows as scan OUTPUTS (ys — written
    # once, never carried: the flat-program property that the round-2
    # global tape lacked) and flush them with ONE bulk scatter-add
    # after the scan. 0 = per-round tiered compact
    # scatter (the march backward's ladder) — opt out if the ys buffer
    # (alloc_rows x (D+1) f32, ~180 MB on the headline scene) is too
    # large. Tape rows are length-homogeneous (padding 1.07-1.12x
    # live), so the allocation arithmetic that killed the per-chunk
    # march tape (worst-chunk caps) does not apply here. Pure
    # performance knob: grads differ only by float summation order
    # (parity-tested).
    bwd_bulk_scatter: int = 1
    # Thresholded-mode TAPE replay shape (ops/tape.py only). 0 (default)
    # = the flat single-while replay, which RETIRES a chunk as soon as
    # every ray in it stopped, trading the program's cheaper per-round
    # body for skipped rounds. 1 = run early-stop
    # replays through the SAME flat round program as exact mode,
    # carrying the stop mask through the scan (post-stop rounds are
    # exact no-ops rewriting idempotent ys rows): pays every
    # structure-bound round but each round has no cond/carried output
    # buffer — the opt-in for scenes whose stops fire too rarely to
    # retire chunks. Outputs BITWISE identical either way
    # (parity-tested). Pure performance knob.
    tape_stop_program: int = 0
    # Backward-only overrides of round_size / chunk_size (0 = inherit).
    # The backward march's per-round fixed costs (compaction map +
    # scatter dispatch) can favour a LARGER backward round/chunk than
    # the forward's. Semantics are round-size
    # invariant (parity-tested); these are pure performance knobs.
    bwd_round_size: int = 0
    bwd_chunk_size: int = 0
    # Two-phase straggler schedule for the FORWARD march: > 0 caps every
    # chunk's while-march at this many rounds (phase A), then COMPACTS
    # all still-active rays batch-wide into dense chunks and finishes
    # them (phase B; repeated exactly if the straggler buffer
    # overflows). EXACT — per-ray sample sequences are unchanged, only
    # the dispatch schedule moves — so render outputs are BIT-IDENTICAL
    # and it is legal on the parity path. (Weight accumulation stays
    # deterministic but its scatter-add ORDER across rays changes, so
    # waccum matches single-phase to ~1 ulp, not bitwise.) A pure
    # performance knob sized by the chunk-straggler round waste.
    # 0 = single-phase march.
    straggler_rounds: int = 0
    # Model-parallel feature pool (multi-chip): when `pool_axis` names a
    # mesh axis (render called inside shard_map over that axis), the
    # features argument is this device's ROW SHARD of the pool; each
    # round's feature gather resolves locally (non-owned rows read 0)
    # and one `lax.psum` over the axis assembles the true rows before
    # any radiometry — every row is owned by exactly one shard, so the
    # reduction is exact. Backward scatters stay local: each device
    # returns the gradient for its own rows. `pool_rows` is the TRUE
    # global row count (pools are padded to a multiple of the axis size;
    # pad rows are never valid). See parallel/render.py.
    pool_axis: Optional[str] = None
    pool_rows: int = 0
    # Mesh axis the RAY batch is sharded over when rendering inside
    # shard_map (2-D DP x MP with pool_axis). The hand-written VJPs must
    # reduce ray-replicated cotangents (feature rows owned by this
    # shard but touched by every ray shard; joint-feature grads) over
    # this axis themselves — shard_map cannot insert psums into a
    # custom_vjp. Leave None under plain jit/GSPMD data parallelism.
    ray_axis: Optional[str] = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Octree structure + auxiliary tensors as a JAX pytree.

    Array fields (pytree leaves):
      child_flat:    (capacity * N^3,) int32, relative child offsets in
                     units of nodes; 0 = leaf cell.
      data_flat:     (capacity * N^3,) int32, feature-pool row index per
                     leaf cell; >= n_features means empty space.
      parent_depth:  (capacity, 2) int32 (packed parent id, depth).
      offset:        (3,) float32 world->tree offset.
      scaling:       (3,) float32 world->tree scale (invradius).
      extra_data:    (K, E) float32 or None (SG/ASG params, joint positions).
      joint_features / skinning_weights / joint_index /
      transformation_matrices: optional per-call animation tensors
                     (parity: data_spec.hpp:67-111).

    Static metadata:
      N:        branching factor.
      n_levels: max number of descent iterations (tree depth + 1).
      n_internal: number of in-use internal nodes (first dim of buffers
                  actually populated); used to size query masks.
    """

    child_flat: jax.Array
    data_flat: jax.Array
    parent_depth: jax.Array
    offset: jax.Array
    scaling: jax.Array
    extra_data: Optional[jax.Array] = None
    joint_features: Optional[jax.Array] = None
    skinning_weights: Optional[jax.Array] = None
    joint_index: Optional[jax.Array] = None
    transformation_matrices: Optional[jax.Array] = None
    N: int = dataclasses.field(default=2, metadata=dict(static=True))
    n_levels: int = dataclasses.field(default=11, metadata=dict(static=True))
    n_internal: int = dataclasses.field(default=1, metadata=dict(static=True))

    @property
    def capacity(self) -> int:
        return self.child_flat.shape[0] // (self.N ** 3)

    def with_(self, **kw) -> "TreeSpec":
        return dataclasses.replace(self, **kw)


def make_tree_spec(
    child: Any,
    data: Any,
    parent_depth: Any,
    offset: Any,
    scaling: Any,
    *,
    n_internal: int,
    n_levels: Optional[int] = None,
    extra_data: Any = None,
    joint_features: Any = None,
    skinning_weights: Any = None,
    joint_index: Any = None,
    transformation_matrices: Any = None,
) -> TreeSpec:
    """Build a TreeSpec from (capacity, N, N, N[, 1])-shaped tables.

    ``n_levels`` defaults to (max depth stored in parent_depth) + 2, which
    bounds root-to-leaf descent for any point.
    """
    child = jnp.asarray(child, jnp.int32)
    N = int(child.shape[1])
    data = jnp.asarray(data, jnp.int32).reshape(child.shape[0], N, N, N)
    parent_depth = jnp.asarray(parent_depth, jnp.int32)
    if n_levels is None:
        pd = np.asarray(jax.device_get(parent_depth))
        max_depth = int(pd[:max(n_internal, 1), 1].max()) if pd.size else 0
        n_levels = max_depth + 2
    return TreeSpec(
        child_flat=child.reshape(-1),
        data_flat=data.reshape(-1),
        parent_depth=parent_depth,
        offset=jnp.asarray(offset, jnp.float32),
        scaling=jnp.asarray(scaling, jnp.float32),
        extra_data=None if extra_data is None else jnp.asarray(extra_data, jnp.float32),
        joint_features=None if joint_features is None else jnp.asarray(joint_features, jnp.float32),
        skinning_weights=None if skinning_weights is None else jnp.asarray(skinning_weights, jnp.float32),
        joint_index=None if joint_index is None else jnp.asarray(joint_index, jnp.int32),
        transformation_matrices=None
        if transformation_matrices is None
        else jnp.asarray(transformation_matrices, jnp.float32),
        N=N,
        n_levels=int(n_levels),
        n_internal=int(n_internal),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Pinhole camera (parity: data_spec.hpp:113-126)."""

    c2w: jax.Array  # (3, 4) or (4, 4)
    fx: float = dataclasses.field(default=1111.111, metadata=dict(static=True))
    fy: float = dataclasses.field(default=1111.111, metadata=dict(static=True))
    width: int = dataclasses.field(default=800, metadata=dict(static=True))
    height: int = dataclasses.field(default=800, metadata=dict(static=True))


def get_out_data_dim(format: int, basis_dim: int, in_data_dim: int) -> int:
    """Color output dims for a render (parity: rt_kernel.cu:1351-1358)."""
    if format != FORMAT_RGBA:
        return (in_data_dim - 1) // basis_dim + 1
    return in_data_dim
