"""N^3-branching sparse voxel octree with an indirected feature pool.

API-parity rebuild of the reference `svox_t/svox.py:78-925` (`N3Tree`),
re-architected for batched XLA programs:

  * The tree is **three separate arrays** exactly like the reference —
    structure (`child`), an int32 index table (`data`), and a dense,
    caller-supplied feature pool — so per-frame animation swaps the
    feature matrix without touching structure (the load-bearing svox_t
    design; see SURVEY.md intro).
  * Structure edits (refine / merge / shrink) are host-side NumPy over
    pulled buffers, then pushed back — they are rare. Hot per-frame ops
    (`construct_tree`, queries, renders) run on device through a cached
    immutable `TreeSpec` pytree (utils/spec.py) so jit caches stay warm
    until the structure actually changes.
  * `.npz` save/load uses the exact reference schema (svox.py:679-752),
    including legacy upstream-svox files whose `data` array holds float
    leaf features: those are converted on load to (feature pool + identity
    index table), giving PlenOctrees asset compatibility.

Documented deviations from reference behavior (all safer supersets):
  * `set()` / `N3TreeView.set` write feature-pool rows (the CUDA-path
    semantics, svox_kernel.cu:96-108); the reference's CPU fallback wrote
    into the int32 index table (a legacy-svox leftover).
  * `merge()`/`reduce_frontier()` in the reference still operate on the
    legacy float `data` array and are shape-broken for svox_t's int32
    index table; here they operate on the feature pool via the index
    table (the meaningful semantics).
  * `partial()` selects channels of the *feature pool*, not of the index
    table.
"""

from __future__ import annotations

import warnings
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import query as query_ops
from ..ops.traversal import pack_index as _pack_jnp
from ..utils.dataformat import DataFormat
from ..utils.spec import DATA_SENTINEL, TreeSpec, make_tree_spec


class N3Tree:
    """N^3 tree: 3D tree with branching factor N per interior node
    (N=2 is the familiar octree).

    .. warning::
        Structure edits (`refine`, `shrink_to_fit`) change buffer shapes,
        which invalidates jit caches and any optimizer state built on
        `features` — re-make optimizers when such a call returns True
        (same contract as the reference, svox.py:84-89).
    """

    def __init__(
        self,
        N=2,
        data_dim=4,
        depth_limit=10,
        init_reserve=1,
        init_refine=0,
        geom_resize_fact=1.5,
        radius=0.5,
        center=[0.5, 0.5, 0.5],
        data_format="RGBA",
        extra_data=None,
        map_location=None,  # accepted for API compat; JAX manages devices
        dtype=jnp.float32,
    ):
        assert N >= 2
        assert depth_limit >= 0
        self.N: int = int(N)
        self.data_dim: int = int(data_dim)
        self.dtype = dtype

        if init_refine > 0:
            for i in range(1, init_refine + 1):
                init_reserve += (N ** i) ** 3

        self.features = jnp.zeros((init_reserve, data_dim), dtype)
        self._data = np.full(
            (init_reserve, N, N, N, 1), DATA_SENTINEL, dtype=np.int32
        )
        self._child = np.zeros((init_reserve, N, N, N), dtype=np.int32)
        self._parent_depth = np.zeros((init_reserve, 2), dtype=np.int32)

        self._n_internal = 1
        self._n_free = 0

        if isinstance(radius, (float, int)):
            radius = [radius] * 3
        radius = np.asarray(radius, np.float32)
        center = np.asarray(center, np.float32)
        self.invradius = 0.5 / radius
        self.offset = 0.5 * (1.0 - center / radius)

        self.depth_limit = int(depth_limit)
        self.geom_resize_fact = float(geom_resize_fact)
        self.data_format = DataFormat(data_format) if data_format is not None else None

        self.extra_data = extra_data

        self._ver = 0
        # Occupancy version: bumped whenever the index table is
        # RE-POINTED (construct_tree / fused frame loops) — structure
        # layout is unchanged (leaf views stay valid, _ver untouched)
        # but anything keyed on which cells are occupied (e.g. cached
        # cost-ordered ray plans) must re-derive.
        self._occ_ver = 0
        self._invalidate()
        self._lock_tree_structure = False
        self._weight_accum = None
        self._rng = np.random.RandomState(0)

        self.filled = self._n_internal

        self.refine(repeats=init_refine)

    # ------------------------------------------------------------------
    # Buffer views (exposed with reference-compatible names/shapes)
    # ------------------------------------------------------------------

    def _ensure_host_data(self):
        """`_data` may transiently live on device after construct_tree();
        pull it back before host-side mutation."""
        if not isinstance(self._data, np.ndarray):
            # np.array (not asarray): device_get may return a read-only view.
            self._data = np.array(jax.device_get(self._data)).reshape(
                -1, self.N, self.N, self.N, 1
            )

    @property
    def data(self) -> np.ndarray:
        """(capacity, N, N, N, 1) int32 index table into the feature pool."""
        self._ensure_host_data()
        return self._data

    @data.setter
    def data(self, value):
        self._data = np.asarray(value, np.int32).reshape(
            -1, self.N, self.N, self.N, 1
        )
        self._invalidate_spec()

    @property
    def child(self) -> np.ndarray:
        return self._child

    @property
    def parent_depth(self) -> np.ndarray:
        return self._parent_depth

    # ------------------------------------------------------------------
    # Spec marshaling (parity: N3Tree._spec, svox.py:899-925)
    # ------------------------------------------------------------------

    def _spec(
        self,
        features=None,
        joint_features=None,
        skinning_weights=None,
        joint_index=None,
        transformation_matrices=None,
        world=True,
    ) -> TreeSpec:
        """Build (and cache) the immutable device TreeSpec.

        ``features`` is accepted for call-site symmetry with the
        reference's `_spec(data, ...)` (svox.py:899) but is NOT stored:
        the feature pool is a separate traced argument of every render
        and query op (the structure/contents decoupling this framework
        is built around), so passing it here is a no-op by design."""
        key = world
        if (
            self._cached_spec.get(key) is None
        ):
            offset = self.offset if world else np.zeros(3, np.float32)
            scaling = self.invradius if world else np.ones(3, np.float32)
            max_depth = int(self._parent_depth[: max(self.filled, 1), 1].max())
            self._cached_spec[key] = make_tree_spec(
                self._child,
                self._data,
                self._parent_depth,
                offset,
                scaling,
                n_internal=self.filled,
                # bound descent by the ACTUAL tree depth (not depth_limit:
                # deeper nodes would silently under-descend, and shallow
                # trees would pay for unused gather rounds)
                n_levels=max_depth + 2,
                extra_data=self.extra_data,
            )
        spec = self._cached_spec[key]
        if (
            joint_features is not None
            or skinning_weights is not None
            or joint_index is not None
            or transformation_matrices is not None
        ):
            spec = spec.with_(
                joint_features=None if joint_features is None else jnp.asarray(joint_features, jnp.float32),
                skinning_weights=None if skinning_weights is None else jnp.asarray(skinning_weights, jnp.float32),
                joint_index=None if joint_index is None else jnp.asarray(joint_index, jnp.int32),
                transformation_matrices=None
                if transformation_matrices is None
                else jnp.asarray(transformation_matrices, jnp.float32),
            )
        return spec

    def _baked_spec(self, transformation_matrices=None,
                    skinning_weights=None, joint_index=None):
        """Baked render structure (ops/bake.py): dense top grid + brick
        atlas — 2 gathers per sample instead of ~depth. Cached; refreshed
        cheaply (one gather) after construct_tree re-points the index
        table."""
        from ..ops import bake as bake_ops

        if self._cached_baked is None:
            self._ensure_host_data()
            self._cached_baked = bake_ops.bake_arrays(
                self._child,
                self._data,
                self._parent_depth,
                self.offset,
                self.invradius,
                self.filled,
                extra_data=self.extra_data,
            )
        baked = self._cached_baked
        updates = {}
        if transformation_matrices is not None:
            updates["transformation_matrices"] = jnp.asarray(
                transformation_matrices, jnp.float32
            )
        if skinning_weights is not None:
            updates["skinning_weights"] = jnp.asarray(
                skinning_weights, jnp.float32
            )
        if joint_index is not None:
            updates["joint_index"] = jnp.asarray(joint_index, jnp.int32)
        if updates:
            import dataclasses as _dc

            baked = _dc.replace(baked, **updates)
        return baked

    # ------------------------------------------------------------------
    # Real-time octree (re)pointing (parity: svox.py:160-161)
    # ------------------------------------------------------------------

    def construct_tree(self, indices):
        """Attach a (Q, 3) world-space point cloud: point i's leaf index
        slot is set to i. Runs fully on device; the index table stays on
        device until a host-side structure op needs it."""
        spec = self._spec()
        new_data_flat = query_ops.construct_tree(spec, jnp.asarray(indices, self.dtype))
        lo = hi = None
        if self._cached_baked is not None:
            lo, hi = query_ops.points_leaf_aabb(
                spec, jnp.asarray(indices, self.dtype)
            )
        self._adopt_data_flat(spec, new_data_flat, lo, hi)

    def _adopt_data_flat(self, spec, new_data_flat, lo=None, hi=None):
        """Adopt a functionally produced index table (construct_tree /
        a fused frame loop): splice it into the jit-cached specs and
        refresh the baked structure, keeping the exact ray-cull box
        valid. Old occupied cells keep their (possibly stale) rows, new
        points may occupy cells outside the old box -> union of the two;
        with lo=None the box conservatively resets to the full cube."""
        cap = spec.capacity
        self._occ_ver += 1
        self._data = new_data_flat.reshape(cap, self.N, self.N, self.N, 1)
        # Keep jit caches warm: splice the new table into cached specs
        # instead of rebuilding them.
        self._cached_spec = {
            k: v.with_(data_flat=new_data_flat) for k, v in self._cached_spec.items()
        }
        if self._cached_baked is not None:
            from ..ops import bake as bake_ops

            old_lo = self._cached_baked.aabb_lo
            old_hi = self._cached_baked.aabb_hi
            if lo is not None and old_lo is not None:
                lo = jnp.minimum(lo, old_lo)
                hi = jnp.maximum(hi, old_hi)
            self._cached_baked = bake_ops.refresh(
                self._cached_baked, new_data_flat, aabb_lo=lo, aabb_hi=hi
            )
            if self._cached_baked.skip_base:
                # keep FAST-mode skip boxes alive across re-pointing
                # (refresh degrades them; device regrowth is ~0.1 ms)
                self._cached_baked = bake_ops.grow_boxes_device(
                    self._cached_baked
                )

    def construct_tree_device(self, spec: TreeSpec, indices) -> TreeSpec:
        """Functional on-device variant for jitted frame loops: returns a
        new TreeSpec with the updated index table (no host sync)."""
        new_data_flat = query_ops.construct_tree(spec, indices)
        return spec.with_(data_flat=new_data_flat)

    # ------------------------------------------------------------------
    # Accessors (parity: svox.py:164-285)
    # ------------------------------------------------------------------

    def set(self, indices, values, cuda=True):
        """Write `values` (Q, data_dim) into the feature rows addressed by
        world points `indices` (Q, 3)."""
        del cuda
        spec = self._spec()
        self.features = query_ops.assign(
            spec,
            jnp.asarray(self.features),
            jnp.asarray(indices, self.dtype),
            jnp.asarray(values, self.dtype),
        )

    def forward(
        self,
        features,
        indices,
        cuda=True,
        want_node_ids=False,
        world=True,
        want_data_ids=False,
        want_leaf_node=False,
    ):
        """Differentiable point query (parity: svox.py:216-285).

        :return: values (Q, data_dim); plus packed node ids, data ids
            and/or the unique hit-leaf list (n_hit, 4) when requested.
        """
        del cuda
        indices = jnp.asarray(indices, self.dtype)
        assert indices.ndim == 2
        spec = self._spec(world=world)
        values, node_ids, data_ids = query_ops.query(
            spec, jnp.asarray(features), indices, world
        )
        if not (want_node_ids or want_data_ids or want_leaf_node):
            return values
        ret = [values]
        if want_node_ids:
            ret.append(node_ids)
        if want_data_ids:
            ret.append(data_ids)
        if want_leaf_node:
            # On-device fixed-capacity compaction (svox_kernel.cu:239-269
            # parity); only the scalar count syncs to host for the trim.
            leaf_node, count = query_ops.unique_leaf_nodes(node_ids, self.N)
            ret.append(leaf_node[: int(count)])
        return ret

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    # ------------------------------------------------------------------
    # Special features (parity: svox.py:288-349)
    # ------------------------------------------------------------------

    def snap(self, indices):
        """Snap points to the lowest corner of their leaf voxel."""
        return self[jnp.asarray(indices, self.dtype)].corners

    def partial(self, data_sel=None, device=None):
        """Copy of the tree with a channel subset of the feature pool."""
        if data_sel is None:
            new_data_dim = self.data_dim
            sel_indices = None
        else:
            sel_indices = np.arange(self.data_dim)[data_sel]
            if sel_indices.ndim == 0:
                sel_indices = sel_indices[None]
            new_data_dim = sel_indices.size
        t2 = N3Tree(
            N=self.N,
            data_dim=int(new_data_dim),
            depth_limit=self.depth_limit,
            geom_resize_fact=self.geom_resize_fact,
        )
        self._ensure_host_data()
        t2.invradius = self.invradius.copy()
        t2.offset = self.offset.copy()
        t2._child = self._child.copy()
        t2._parent_depth = self._parent_depth.copy()
        t2._data = self._data.copy()
        t2._n_internal = self._n_internal
        t2._n_free = self._n_free
        t2.filled = self.filled
        t2.extra_data = None if self.extra_data is None else self.extra_data.copy()
        t2.data_format = self.data_format
        feats = np.asarray(jax.device_get(self.features))
        if sel_indices is not None:
            feats = feats[:, sel_indices]
        t2.features = jnp.asarray(feats)
        t2._invalidate()
        return t2

    def clone(self, device=None):
        return self.partial(device=device)

    # ------------------------------------------------------------------
    # Frontier ops (parity: svox.py:352-483)
    # ------------------------------------------------------------------

    def _leaf_feature_values(self, features, nid: np.ndarray) -> np.ndarray:
        """(len(nid), N^3, data_dim) feature values of each node's cells
        (empty cells → zeros)."""
        self._ensure_host_data()
        feats = np.asarray(jax.device_get(features))
        idx = self._data[nid, ..., 0].reshape(len(nid), -1)
        valid = idx < feats.shape[0]
        safe = np.where(valid, idx, 0)
        vals = feats[safe]
        vals[~valid] = 0.0
        return vals

    def merge(self, frontier_sel=None, op=np.mean, features=None):
        """Merge leaves into selected frontier nodes (nodes whose children
        are all leaves). The parent becomes a leaf pointing at its first
        non-empty child's feature row; with `op` (default np.mean, parity
        with the reference's `op=torch.mean` — svox.py:352) that row is
        overwritten with op over the OCCUPIED children's feature rows
        (empty cells are excluded from the reduction, so a frontier with
        one occupied child keeps that child's features rather than an
        N^3-diluted mean) and the updated pool is stored back on the
        tree; `op=None` keeps the first child's row untouched. (The
        reference applies op to its int32 *index table* — an
        upstream-svox holdover that scrambles the svox_t indirection;
        reducing the feature rows is the sane interpretation.) Use
        shrink_to_fit() to recover freed nodes."""
        self._ensure_host_data()
        if self.n_internal - self._n_free <= 1:
            raise RuntimeError("Cannot merge root node")
        nid = self._frontier if frontier_sel is None else self._frontier[frontier_sel]
        nid = np.atleast_1d(np.asarray(nid))
        if nid.size == 0:
            return False
        child_idx = self._data[nid, ..., 0].reshape(len(nid), -1)  # (K, N^3)
        feats_np = np.array(jax.device_get(self.features if features is None else features))
        valid = child_idx < feats_np.shape[0]
        first_valid = np.where(
            valid.any(axis=1), np.argmax(valid, axis=1), 0
        )
        parent_row = child_idx[np.arange(len(nid)), first_valid]
        parent_row = np.where(valid.any(axis=1), parent_row, DATA_SENTINEL)

        if op is not None:
            # feats_np already holds the pool — don't device_get it a
            # second time (a device-to-host copy of a big pool).
            vals = self._leaf_feature_values(feats_np, nid)
            ok = parent_row < feats_np.shape[0]
            if op is np.mean:
                # Vectorized occupied-only mean (the default; a frontier
                # can span tens of thousands of nodes on this 1-core
                # host, so avoid a per-node Python loop).
                cnt = valid.sum(axis=1)
                summed = np.where(valid[..., None], vals, 0.0).sum(axis=1)
                mean = summed / np.maximum(cnt, 1)[:, None]
                rows = parent_row[ok]
                feats_np[rows] = mean[ok]
            else:
                # Exotic reductions fall back to a per-node loop.
                for i in np.flatnonzero(ok):
                    reduced = op(vals[i][valid[i]], axis=0)
                    if isinstance(reduced, tuple):
                        reduced = reduced[0]
                    feats_np[parent_row[i]] = reduced
            self.features = jnp.asarray(feats_np)

        parent_sel = tuple(self._unpack_index_np(self._parent_depth[nid, 0]).T)
        self._data[parent_sel + (0,)] = parent_row
        self._child[parent_sel] = 0
        self._parent_depth[nid] = -1
        self._n_free += nid.shape[0]
        self._invalidate()
        return True

    def _leaf_feature_values_jnp(self, features, nid: np.ndarray):
        """Differentiable (len(nid), N^3, data_dim) child feature values
        (empty cells → zeros): jnp gather, grads flow to `features`."""
        self._ensure_host_data()
        feats = jnp.asarray(features)
        idx = self._data[nid, ..., 0].reshape(len(nid), -1)
        valid = jnp.asarray(idx < feats.shape[0])
        safe = jnp.asarray(np.where(idx < feats.shape[0], idx, 0))
        return jnp.where(valid[..., None], feats[safe], 0.0)

    def reduce_frontier(self, op=None, dim=None, grad=False, features=None):
        """Reduce child leaf feature values for each frontier node
        (parity: svox.py:391-420). With ``grad=True`` the result is a JAX
        array differentiable wrt the feature pool (the reference's
        ``grad`` flag keeps the autograd graph); ``grad=False`` returns
        host NumPy. `op` takes (vals, axis=1); default mean."""
        nid = self._frontier
        if grad:
            if op is None:
                op = jnp.mean
            vals = self._leaf_feature_values_jnp(
                self.features if features is None else features, nid
            )
            if dim is not None:
                vals = vals[..., dim]
            return op(vals, axis=1)
        if op is None:
            op = np.mean
        vals = self._leaf_feature_values(
            self.features if features is None else features, nid
        )
        if dim is not None:
            vals = vals[..., dim]
        return op(vals, axis=1)

    def max_frontier(self, dim=None, grad=False, features=None):
        return self.reduce_frontier(
            op=jnp.max if grad else np.max, dim=dim, grad=grad,
            features=features,
        )

    def diam_frontier(self, dim=None, grad=False, scale=1.0, features=None):
        """Max pairwise distance among each frontier node's child values
        (parity: svox.py:439-468)."""
        xp = jnp if grad else np
        get_vals = (
            self._leaf_feature_values_jnp if grad else self._leaf_feature_values
        )
        vals = get_vals(
            self.features if features is None else features, self._frontier
        )
        if dim is not None:
            vals = vals[..., dim]
        if vals.ndim == 2:
            vals = vals[:, :, None]
        delta = (vals[:, :, None, :] - vals[:, None, :, :]) * scale
        return xp.max(xp.linalg.norm(delta, axis=-1), axis=(1, 2))

    @property
    def _frontier(self) -> np.ndarray:
        """Internal nodes whose children are all leaves (svox.py:471-483)."""
        if self._last_frontier is None:
            ni = self.n_internal
            sel = (self._child[:ni] == 0).reshape(ni, -1).all(axis=1)
            sel &= self._parent_depth[:ni, 0] != -1
            self._last_frontier = np.nonzero(sel)[0]
        return self._last_frontier

    # ------------------------------------------------------------------
    # Refinement & memory management (parity: svox.py:488-642)
    # ------------------------------------------------------------------

    def _node_cells(self, nodes: np.ndarray) -> np.ndarray:
        """(len(nodes) * N^3, 4) [node, x, y, z] rows covering every cell
        of the given nodes, cells in row-major order within each node."""
        N = self.N
        grid = np.stack(
            np.meshgrid(
                np.arange(N), np.arange(N), np.arange(N), indexing="ij"
            ),
            axis=-1,
        ).reshape(-1, 3)
        out = np.empty((len(nodes), N ** 3, 4), np.int64)
        out[:, :, 0] = np.asarray(nodes)[:, None]
        out[:, :, 1:] = grid[None]
        return out.reshape(-1, 4)

    def refine(self, repeats=1, sel=None, leaf_node=None, node_id=None):
        """Refine selected leaves (default: all below depth_limit).

        Each selected leaf cell becomes an internal node whose N^3 child
        cells inherit the parent cell's index-table entry; new nodes are
        appended at the tail of the node arrays, and `child` keeps
        parent-relative offsets (capability parity: svox.py:488-560 —
        re-designed around an explicit (L, 4) target-row list; also
        honors depth_limit on EVERY pass, where the reference filters
        only the first and can exceed its documented contract).

        :param sel: tuple of 4 index arrays (node, x, y, z), or None.
        :param leaf_node: optional (L, 4) array equivalent of `sel`.
        :return: True iff buffers were resized (re-make optimizers!).
        """
        if self._lock_tree_structure:
            raise RuntimeError("Tree locked")
        self._ensure_host_data()
        resized = False
        mutated = False
        if sel is not None or leaf_node is not None:
            targets = (
                np.asarray(leaf_node)
                if leaf_node is not None
                else np.stack([np.asarray(t) for t in sel], axis=-1)
            )
        else:
            targets = None
        for pass_no in range(repeats):
            if targets is None:
                leaves = self._all_leaves()
                targets = leaves[
                    self._parent_depth[leaves[:, 0], 1] < self.depth_limit
                ]
            n_new = len(targets)
            if n_new == 0:
                break
            base = self.filled
            shortfall = base + n_new - self.capacity
            if shortfall > 0:
                self._grow_buffers(shortfall)
                resized = True

            parents = targets[:, 0].astype(np.int32)
            cells = (parents,) + tuple(targets[:, 1 + a] for a in range(3))
            ids = base + np.arange(n_new, dtype=np.int32)
            # Each split cell points (relatively) at its new node ...
            self._child[cells] = ids - parents
            # ... whose cells all inherit the split cell's data pointer.
            self._data[ids] = self._data[cells][:, None, None, None]
            self._parent_depth[ids, 0] = (
                self._pack_index_np(targets) if node_id is None else node_id
            )
            child_depth = self._parent_depth[parents, 1] + 1
            self._parent_depth[ids, 1] = child_depth
            self._n_internal += n_new
            self.filled += n_new
            mutated = True
            node_id = None  # caller-supplied ids apply to the first pass only
            if pass_no + 1 < repeats:
                # Next pass splits every cell of the nodes just created
                # (all still leaves), minus nodes already at the limit.
                targets = self._node_cells(ids[child_depth < self.depth_limit])
        if mutated:
            self._invalidate()
        return resized

    def _refine_at(self, intnode_idx, xyzi):
        """Refine one specific leaf (testing helper, svox.py:562-598)."""
        if self._lock_tree_structure:
            raise RuntimeError("Tree locked")
        self._ensure_host_data()
        assert min(xyzi) >= 0 and max(xyzi) < self.N
        if self._parent_depth[intnode_idx, 1] >= self.depth_limit:
            return
        xi, yi, zi = xyzi
        if self._child[intnode_idx, xi, yi, zi] != 0:
            return
        resized = False
        filled = self.n_internal
        if filled >= self.capacity:
            self._resize_add_cap(1)
            resized = True
        self._child[filled] = 0
        self._child[intnode_idx, xi, yi, zi] = filled - intnode_idx
        depth = self._parent_depth[intnode_idx, 1] + 1
        self._parent_depth[filled, 0] = self._pack_index_np(
            np.array([[intnode_idx, xi, yi, zi]], dtype=np.int32)
        )[0]
        self._parent_depth[filled, 1] = depth
        self._data[filled, :, :, :] = self._data[intnode_idx, xi, yi, zi]
        self._data[intnode_idx, xi, yi, zi] = 0
        self._n_internal += 1
        self.filled += 1
        self._invalidate()
        return resized

    def shrink_to_fit(self):
        """Defragment and trim the node buffers to the live node count
        (capability parity: svox.py:600-642, re-designed around an
        explicit old->new node-id map applied directly to each kept
        node's own links — instead of back-adjusting through parent
        pointers, whose raw-shift arithmetic silently corrupts packed
        parent ids in the reference, svox.py:627).
        Breaks optimizers if it returns True."""
        if self._lock_tree_structure:
            raise RuntimeError("Tree locked")
        self._ensure_host_data()
        n_nodes = self.n_internal
        live = n_nodes - self._n_free
        if live >= self.capacity:
            return False
        if self._n_free:
            N3 = self.N ** 3
            keep = self._parent_depth[:n_nodes, 0] != -1
            # Old -> new node id under order-preserving compaction.
            new_id = np.cumsum(keep, dtype=np.int64) - 1
            old_ids = np.flatnonzero(keep)
            # `child` offsets are parent-relative: re-express each
            # nonzero offset in the compacted id space. (A live node
            # never points at a freed one — merging zeroes the parent's
            # cell — so every absolute target is itself kept.)
            offs = self._child[old_ids]
            shift = new_id[old_ids]
            offs = np.where(
                offs != 0,
                new_id[old_ids[:, None, None, None] + offs]
                - shift[:, None, None, None],
                0,
            ).astype(np.int32)
            # Packed parent links are parent_id * N^3 + cell: remap only
            # the node part.
            links = self._parent_depth[old_ids].copy()
            links[:, 0] = (
                new_id[links[:, 0] // N3] * N3 + links[:, 0] % N3
            ).astype(np.int32)
            self._child = offs
            self._data = self._data[old_ids]
            self._parent_depth = links
            self._n_internal = live
            self._n_free = 0
        else:
            self._data = self._data[:live]
            self._child = self._child[:live]
            self._parent_depth = self._parent_depth[:live]
        self.filled = min(self.filled, live)
        self._invalidate()
        return True

    # ------------------------------------------------------------------
    # Misc (parity: svox.py:645-676)
    # ------------------------------------------------------------------

    @property
    def n_leaves(self):
        return self._all_leaves().shape[0]

    @property
    def n_internal(self):
        return self._n_internal

    @property
    def capacity(self):
        return self._parent_depth.shape[0]

    @property
    def max_depth(self):
        return int(self.depths.max())

    def accumulate_weights(self):
        """Context manager collecting per-leaf render contribution weights
        (parity: svox.py:664-676)."""
        return WeightAccumulator(self)

    # ------------------------------------------------------------------
    # Persistence (parity: svox.py:679-752)
    # ------------------------------------------------------------------

    def save(self, path, shrink=True, compress=True):
        """Save structure to .npz with the exact reference schema."""
        self._ensure_host_data()
        if shrink:
            self.shrink_to_fit()
        data = {
            "data_dim": self.data_dim,
            "child": self._child,
            "parent_depth": self._parent_depth,
            "n_internal": self._n_internal,
            "n_free": self._n_free,
            "invradius3": self.invradius,
            "offset": self.offset,
            "depth_limit": self.depth_limit,
            "geom_resize_fact": self.geom_resize_fact,
            "data": self._data,
        }
        if self.data_format is not None:
            data["data_format"] = repr(self.data_format)
        if self.extra_data is not None:
            data["extra_data"] = self.extra_data
        # Extension over the reference schema: persist the feature pool
        # alongside (the reference keeps features external; loading a file
        # without this key simply leaves `features` at zeros).
        data["features"] = np.asarray(jax.device_get(self.features))
        if compress:
            np.savez_compressed(path, **data)
        else:
            np.savez(path, **data)

    @classmethod
    def load(cls, path, map_location=None):
        """Load from .npz — svox_t files (int32 index-table `data`),
        legacy upstream-svox files (float leaf features in `data`), and
        this framework's extended files (with a `features` key)."""
        z = np.load(path)
        tree = cls(
            extra_data=z["extra_data"] if "extra_data" in z.files else None
        )
        tree.data_dim = int(z["data_dim"])
        tree._child = np.asarray(z["child"], np.int32)
        tree.N = int(tree._child.shape[-1])
        tree._parent_depth = np.asarray(z["parent_depth"], np.int32)
        tree._n_internal = int(z["n_internal"])
        tree.filled = tree._n_internal
        if "invradius3" in z.files:
            tree.invradius = np.asarray(z["invradius3"], np.float32)
        else:
            tree.invradius = np.full((3,), float(z["invradius"]), np.float32)
        tree.offset = np.asarray(z["offset"], np.float32)
        tree.depth_limit = int(z["depth_limit"])
        tree.geom_resize_fact = float(z["geom_resize_fact"])
        raw = np.asarray(z["data"])
        cap = tree._child.shape[0]
        N = tree.N
        if np.issubdtype(raw.dtype, np.floating):
            # Legacy upstream-svox: `data` holds (cap,N,N,N,data_dim) float
            # leaf features. Convert to pool + identity index table.
            feats = raw.reshape(-1, tree.data_dim).astype(np.float32)
            tree.features = jnp.asarray(feats)
            tree._data = np.arange(cap * N ** 3, dtype=np.int32).reshape(
                cap, N, N, N, 1
            )
        else:
            tree._data = raw.astype(np.int32).reshape(cap, N, N, N, 1)
            if "features" in z.files:
                tree.features = jnp.asarray(np.asarray(z["features"], np.float32))
            else:
                tree.features = jnp.zeros((1, tree.data_dim), tree.dtype)
        tree._n_free = int(z["n_free"]) if "n_free" in z.files else 0
        tree.data_format = (
            DataFormat(str(z["data_format"])) if "data_format" in z.files else None
        )
        tree._invalidate()
        return tree

    # ------------------------------------------------------------------
    # Magic (parity: svox.py:755-801)
    # ------------------------------------------------------------------

    def __repr__(self):
        return (
            f"svox_t_tpu.N3Tree(N={self.N}, data_dim={self.data_dim}, "
            f"depth_limit={self.depth_limit}, "
            f"capacity:{self.n_internal - self._n_free}/{self.capacity}, "
            f"data_format:{self.data_format or 'RGBA'})"
        )

    def __getitem__(self, key):
        from .view import N3TreeView

        return N3TreeView(self, key)

    def __setitem__(self, key, val):
        from .view import N3TreeView

        N3TreeView(self, key).set(val)

    def __iadd__(self, val):
        self[:] += val
        return self

    def __isub__(self, val):
        self[:] -= val
        return self

    def __imul__(self, val):
        self[:] *= val
        return self

    def __idiv__(self, val):
        self[:] /= val
        return self

    @property
    def ndim(self):
        return 2

    @property
    def shape(self):
        return (self.n_leaves, self.data_dim)

    def size(self, dim):
        return self.data_dim if dim == 1 else self.n_leaves

    def numel(self):
        return self.data_dim * self.n_leaves

    def __len__(self):
        return self.n_leaves

    # ------------------------------------------------------------------
    # Internal utils (parity: svox.py:804-897)
    # ------------------------------------------------------------------

    def _calc_corners(self, nodes):
        """Tree-space lower corners for (Q, 4) [node,x,y,z] selectors."""
        spec = self._spec()
        return query_ops.calc_corners(spec, jnp.asarray(np.asarray(nodes), jnp.int32))

    def _pack_index_np(self, txyz: np.ndarray) -> np.ndarray:
        N = self.N
        return ((txyz[:, 0] * N + txyz[:, 1]) * N + txyz[:, 2]) * N + txyz[:, 3]

    def _unpack_index_np(self, flat: np.ndarray) -> np.ndarray:
        N = self.N
        flat = np.asarray(flat).astype(np.int64)
        z = flat % N
        flat = flat // N
        y = flat % N
        flat = flat // N
        x = flat % N
        node = flat // N
        return np.stack([node, x, y, z], axis=-1)

    def _pack_index(self, txyz):
        return _pack_jnp(jnp.asarray(txyz), self.N)

    def _unpack_index(self, flat):
        """(Q,) packed ids -> (Q, 4) [node, x, y, z] (svox.py:833-838)."""
        return self._unpack_index_np(np.asarray(jax.device_get(flat)))

    def _make_val_tensor(self, val):
        """Broadcast a scalar / (1,)-channel value to (Q, data_dim)
        (parity: svox.py:865-874)."""
        val = jnp.asarray(val, self.dtype)
        while val.ndim < 2:
            val = val[None]
        if val.shape[-1] == 1:
            val = jnp.broadcast_to(val, val.shape[:-1] + (self.data_dim,))
        else:
            assert val.shape[-1] == self.data_dim
        return val

    def _grow_buffers(self, min_extra: int):
        """Grow node-array capacity: fresh allocations sized to at least
        `min_extra` more rows and at least geom_resize_fact relative
        growth, old contents copied in (capability parity: svox.py:
        841-863 — the reference's GPU-OOM offload dance is moot here,
        these buffers live in host RAM). New index-table rows start at
        the empty sentinel; new structure rows at zero."""
        old_cap = self.capacity
        new_cap = max(
            old_cap + int(min_extra), int(old_cap * self.geom_resize_fact)
        )

        def grown(arr, fill):
            out = np.full((new_cap,) + arr.shape[1:], fill, arr.dtype)
            out[:old_cap] = arr
            return out

        self._data = grown(self._data, DATA_SENTINEL)
        self._child = grown(self._child, 0)
        self._parent_depth = grown(self._parent_depth, 0)

    # Backwards-compatible name (reference-era internal API).
    _resize_add_cap = _grow_buffers

    def _all_leaves(self) -> np.ndarray:
        if self._last_all_leaves is None:
            self._last_all_leaves = np.stack(
                np.nonzero(self._child[: self.n_internal] == 0), axis=-1
            )
        return self._last_all_leaves

    def world2tree(self, indices):
        return jnp.asarray(self.offset) + jnp.asarray(indices) * jnp.asarray(
            self.invradius
        )

    def tree2world(self, indices):
        return (jnp.asarray(indices) - jnp.asarray(self.offset)) / jnp.asarray(
            self.invradius
        )

    def _invalidate(self):
        self._ver += 1
        self._occ_ver += 1
        self._last_all_leaves = None
        self._last_frontier = None
        self._cached_spec = {}
        self._cached_baked = None

    def _invalidate_spec(self):
        """Contents-only change (index table): jit-relevant arrays change
        but leaf-view keys remain valid (reference keeps _ver too)."""
        self._occ_ver += 1
        self._cached_spec = {}
        self._cached_baked = None

    @property
    def extra_data(self):
        """Auxiliary per-tree tensor (SG/ASG params, joint positions;
        parity: svox.py:145-149). Assigning it invalidates cached device
        specs so renders pick up the new value."""
        return self._extra_data

    @extra_data.setter
    def extra_data(self, value):
        self._extra_data = (
            None if value is None else np.asarray(value, np.float32)
        )
        if hasattr(self, "_cached_spec"):
            self._invalidate_spec()

    # Redirected leaf-view conveniences (parity: svox.py:929-946)
    @property
    def depths(self):
        return self[:].depths

    @property
    def lengths(self):
        return self[:].lengths

    @property
    def lengths_local(self):
        return self[:].lengths_local

    @property
    def corners(self):
        return self[:].corners

    @property
    def corners_local(self):
        return self[:].corners_local

    @property
    def values(self):
        return self[:].values

    @property
    def values_local(self):
        return self[:].values_local

    def sample(self, n_samples, device=None):
        return self[:].sample(n_samples, device=device)

    def sample_local(self, n_samples):
        return self[:].sample_local(n_samples)

    def aux(self, arr):
        return self[:].aux(arr)

    def normal_(self, mean=0.0, std=1.0):
        return self[:].normal_(mean, std)

    def clamp_(self, min=None, max=None):
        return self[:].clamp_(min, max)

    def uniform_(self, min=0.0, max=1.0):
        return self[:].uniform_(min, max)

    def relu_(self):
        return self[:].relu_()

    def sigmoid_(self):
        return self[:].sigmoid_()

    def nan_to_num_(self, inf_val=2e4):
        return self[:].nan_to_num_(inf_val)


class WeightAccumulator:
    """Context manager for per-leaf render weight accumulation
    (parity: svox.py:948-969). While active, the tree is structure-locked
    and every `VolumeRenderer.forward` adds its per-leaf weights."""

    def __init__(self, tree: N3Tree):
        self.tree = tree

    def __enter__(self):
        self.tree._lock_tree_structure = True
        self.tree._weight_accum = jnp.zeros(
            self.tree._child.shape, jnp.float32
        )
        return self

    def __exit__(self, type, value, traceback):
        self.weight_accum = self.tree._weight_accum
        self.tree._weight_accum = None
        self.tree._lock_tree_structure = False

    @property
    def value(self):
        wa = self.tree._weight_accum
        return wa if wa is not None else self.weight_accum

    def __call__(self):
        return self.tree.aux(np.asarray(jax.device_get(self.value)))
