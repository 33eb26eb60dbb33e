"""Point query / assign / construct_tree / calc_corners tests
(SURVEY.md stage S2)."""

import jax
import jax.numpy as jnp
import numpy as np

import svox_t_tpu as st
from svox_t_tpu.ops.query import assign, calc_corners, construct_tree, query

from helpers import build_tree


def test_query_returns_attached_features(rng):
    t, feats, centers = build_tree(rng)
    spec = t._spec()
    vals, node_ids, data_ids = query(spec, feats, jnp.asarray(centers), True)
    np.testing.assert_allclose(np.asarray(vals), np.asarray(feats), atol=0)
    np.testing.assert_array_equal(
        np.asarray(data_ids), np.arange(centers.shape[0])
    )


def test_query_local_vs_world(rng):
    t, feats, centers = build_tree(rng)
    spec_w = t._spec(world=True)
    spec_l = t._spec(world=False)
    local = np.asarray(jax.device_get(t.world2tree(jnp.asarray(centers))))
    v1, n1, d1 = query(spec_w, feats, jnp.asarray(centers), True)
    v2, n2, d2 = query(spec_l, feats, jnp.asarray(local), False)
    np.testing.assert_array_equal(np.asarray(n1), np.asarray(n2))
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2))


def test_query_empty_leaf_zero(rng):
    t = st.N3Tree(N=2, data_dim=4)  # fresh tree: all leaves empty
    feats = jnp.asarray(rng.randn(5, 4).astype(np.float32))
    pts = jnp.asarray(rng.rand(10, 3).astype(np.float32))
    vals, node_ids, data_ids = query(t._spec(), feats, pts, True)
    np.testing.assert_allclose(np.asarray(vals), 0.0)
    assert (np.asarray(data_ids) >= 5).all()


def test_query_grad_scatter(rng):
    t, feats, centers = build_tree(rng)
    spec = t._spec()
    pts = jnp.asarray(centers[:10])

    def loss(f):
        vals, _, _ = query(spec, f, pts, True)
        return jnp.sum(vals * 2.0)

    g = np.asarray(jax.grad(loss)(feats))
    want = np.zeros_like(g)
    want[:10] = 2.0
    np.testing.assert_allclose(g, want)


def test_query_grad_duplicate_points_accumulate(rng):
    t, feats, centers = build_tree(rng)
    spec = t._spec()
    pts = jnp.asarray(np.repeat(centers[:1], 4, axis=0))

    def loss(f):
        vals, _, _ = query(spec, f, pts, True)
        return jnp.sum(vals)

    g = np.asarray(jax.grad(loss)(feats))
    np.testing.assert_allclose(g[0], 4.0)


def test_assign_writes_rows(rng):
    t, feats, centers = build_tree(rng)
    spec = t._spec()
    newvals = jnp.asarray(rng.randn(5, 4).astype(np.float32))
    feats2 = assign(spec, feats, jnp.asarray(centers[:5]), newvals)
    np.testing.assert_allclose(np.asarray(feats2[:5]), np.asarray(newvals))
    np.testing.assert_allclose(np.asarray(feats2[5:]), np.asarray(feats[5:]))


def test_construct_tree_points_rows(rng):
    t, feats, centers = build_tree(rng)
    spec = t._spec()
    # re-point with a permuted cloud: leaf of point i gets id i
    perm = rng.permutation(centers.shape[0])
    new_data = construct_tree(spec, jnp.asarray(centers[perm]))
    spec2 = spec.with_(data_flat=new_data)
    vals, _, data_ids = query(spec2, feats, jnp.asarray(centers[perm]), True)
    np.testing.assert_array_equal(
        np.asarray(data_ids), np.arange(centers.shape[0])
    )


def test_shared_leaf_takes_highest_point_index(rng):
    """Several points in one leaf: construct_tree and assign keep the
    highest-indexed point, as a sequential loop would, whatever order
    the backend applies duplicate scatter updates in."""
    t, feats, centers = build_tree(rng)
    spec = t._spec()
    # points 0, 2 and 4 share leaf A, point 1 and 3 share leaf B
    pts = jnp.asarray(centers[[0, 1, 0, 1, 0]])
    new_data = construct_tree(spec, pts)
    _, _, data_ids = query(spec.with_(data_flat=new_data), feats,
                           jnp.asarray(centers[:2]), True)
    np.testing.assert_array_equal(np.asarray(data_ids), [4, 3])

    vals = jnp.asarray(np.arange(5 * 4, dtype=np.float32).reshape(5, 4))
    feats2 = np.asarray(assign(spec, feats, pts, vals))
    np.testing.assert_array_equal(feats2[0], np.asarray(vals[4]))
    np.testing.assert_array_equal(feats2[1], np.asarray(vals[3]))
    np.testing.assert_array_equal(feats2[2:], np.asarray(feats[2:]))


def test_calc_corners_against_python(rng):
    t, feats, centers = build_tree(rng)
    leaves = t._all_leaves()
    spec = t._spec()
    corners = np.asarray(calc_corners(spec, jnp.asarray(leaves, jnp.int32)))
    # independent recomputation in python: walk up parents
    pd = t.parent_depth
    N = t.N
    for row in range(0, len(leaves), max(1, len(leaves) // 7)):
        node, x, y, z = leaves[row]
        out = np.zeros(3)
        curr = [node, x, y, z]
        while True:
            out = (out + curr[1:]) / N
            if curr[0] == 0:
                break
            packed = pd[curr[0], 0]
            n2 = packed // (N ** 3)
            rem = packed % (N ** 3)
            curr = [n2, rem // (N * N), (rem // N) % N, rem % N]
        np.testing.assert_allclose(corners[row], out, atol=1e-6)


def test_tree_forward_api(rng):
    t, feats, centers = build_tree(rng)
    out = t(feats, jnp.asarray(centers[:5]))
    assert out.shape == (5, t.data_dim)
    vals, nids, dids, leaf = t(
        feats,
        jnp.asarray(centers[:5]),
        want_node_ids=True,
        want_data_ids=True,
        want_leaf_node=True,
    )
    assert np.asarray(leaf).shape[1] == 4
    assert len(np.asarray(leaf)) <= 5


def test_set_api(rng):
    t, feats, centers = build_tree(rng)
    t.features = feats
    vals = np.full((3, 4), 7.0, np.float32)
    t.set(jnp.asarray(centers[:3]), jnp.asarray(vals))
    got = np.asarray(t(t.features, jnp.asarray(centers[:3])))
    np.testing.assert_allclose(got, vals)


def test_unique_leaf_nodes_on_device(rng):
    """On-device fixed-capacity compaction matches np.unique and is
    jittable (parity: svox_kernel.cu:239-269, 312 — minus the host sync)."""
    import jax
    from svox_t_tpu.ops import query as query_ops

    t, feats, centers = build_tree(rng)
    # duplicate points so node_ids contain repeats
    pts = np.concatenate([centers[:20], centers[:10], centers[5:15]])
    spec = t._spec()
    _, node_ids, _ = query_ops.query(
        spec, feats, jnp.asarray(pts, np.float32), True
    )
    leaf, count = jax.jit(
        lambda ids: query_ops.unique_leaf_nodes(ids, t.N)
    )(node_ids)
    n = int(count)
    got = np.asarray(leaf)
    # padded rows are -1 beyond count
    assert (got[n:] == -1).all()
    # matches host np.unique + unpack, in the same (sorted) order
    uniq = np.unique(np.asarray(jax.device_get(node_ids)))
    assert n == len(uniq)
    expect = t._unpack_index_np(uniq)
    np.testing.assert_array_equal(got[:n], expect)
    # tree.forward(want_leaf_node=True) returns the trimmed list
    _, leaf2 = t(feats, jnp.asarray(pts, np.float32), want_leaf_node=True)
    np.testing.assert_array_equal(np.asarray(leaf2), expect)


def test_points_leaf_aabb_contains_descended_cells_n3(rng):
    """The cull AABB must contain the exact leaf cells the descent picked,
    even at N=3 where one-shot floor(pos * cube_sz) disagrees with the
    iterative descent near cell boundaries (regression: conservative-cull
    contract of _clip_to_occupied)."""
    from svox_t_tpu.models.tree import N3Tree
    from svox_t_tpu.ops.query import points_leaf_aabb
    from svox_t_tpu.ops.traversal import descend

    tree = N3Tree(N=3, data_dim=4, init_refine=1, depth_limit=6)
    # refine a couple of leaves so depths are mixed
    tree._refine_at(0, (0, 0, 0))
    tree._refine_at(0, (2, 2, 2))
    spec = tree._spec()
    # concentrate points near multiples of 1/3^k, where the float paths split
    base = rng.randint(0, 3 ** 4, size=(4000, 3)).astype(np.float32) / 3 ** 4
    jitter = (rng.random_sample((4000, 3)).astype(np.float32) - 0.5) * 1e-6
    pts = np.clip(base + jitter, 0.0, 1.0 - 1e-6)
    lo, hi = points_leaf_aabb(spec, jnp.asarray(pts), world=False)
    leaf, cell = descend(spec, jnp.asarray(pts), with_cell=True)
    cs = np.asarray(leaf.cube_sz)[:, None]
    cell = np.asarray(cell)
    lo_cells = cell / cs
    hi_cells = (cell + 1) / cs
    assert (np.asarray(lo) <= lo_cells.min(0) + 1e-7).all()
    assert (np.asarray(hi) >= hi_cells.max(0) - 1e-7).all()


def test_view_integer_point_key_routes_to_point_query(rng):
    """A 2-D (B, 3) integer array key is a batch of points (the reference
    casts to float, helpers.py:53-56), not a leaf fancy-index."""
    t, feats, centers = build_tree(rng)
    t.features = feats
    ikey = np.round(centers * 64).astype(np.int64)  # ints, same points scaled
    fkey = ikey.astype(np.float32)
    vi = t[ikey].values
    vf = t[fkey].values
    np.testing.assert_allclose(np.asarray(vi), np.asarray(vf), atol=0)
