"""Multi-GPU scaling over a device mesh: ray DP and feature-pool MP.

The reference has no distributed machinery at all (SURVEY.md §2.3) — its
only parallelism is single-GPU SIMT. Two mesh axes cover the workload:

* **Ray data parallelism** (`make_ray_mesh` / `render_sharded` /
  `make_train_step`): tree structure and the feature pool are replicated;
  rays/pixels are sharded across devices; the only communication is the
  feature-gradient all-reduce, which GSPMD inserts automatically as a
  single `psum` when the sharded backward scatter-adds into the
  replicated pool.
* **Feature-pool model parallelism** (`shard_pool` /
  `render_pool_sharded` / `make_pool_train_step`): for scenes whose pool
  + optimizer state outgrow one device's memory, the pool is ROW-sharded over
  a mesh axis; each round's gather resolves locally and one `psum` over
  the pool axis assembles true rows before radiometry (every row has
  exactly one owner, so the reduction is exact). Gradients stay local to
  each shard. Compose both on a 2-D mesh for DP x MP.

Usage:
    mesh = make_ray_mesh()                       # all devices, axis "rays"
    out = render_sharded(mesh, spec, features, rays, opt)
    step = make_train_step(mesh, opt, optimizer) # jitted fwd+bwd+update

    mesh2 = Mesh(devices.reshape(4, 2), ("rays", "pool"))   # DP x MP
    step = make_pool_train_step(mesh2, opt, n_features=M)
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import render as render_ops
from ..utils.spec import Rays, RenderOptions, TreeSpec

# render_pool_sharded's built shard_map+jit callables, keyed by
# (mesh, options, axes, spec treedef) — see the build site.
_POOL_RENDER_CACHE: dict = {}


def make_ray_mesh(devices=None, axis_name: str = "rays") -> Mesh:
    """1-D mesh over all (or given) devices, sharding axis `rays`."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def replicate_spec(mesh: Mesh, tree_or_spec) -> TreeSpec:
    """Place all tree arrays fully replicated on the mesh. Takes an
    N3Tree (its TreeSpec) or a spec pytree (TreeSpec or BakedTree)."""
    spec = tree_or_spec._spec() if hasattr(tree_or_spec, "_spec") else tree_or_spec
    repl = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, repl), spec)


def shard_rays(mesh: Mesh, rays: Rays, axis_name: str = "rays") -> Rays:
    """Shard a ray batch along its leading dim. Batch size must divide by
    the mesh size (pad beforehand if needed)."""
    sh = NamedSharding(mesh, P(axis_name))
    return Rays(*(jax.device_put(jnp.asarray(x), sh) for x in rays))


def render_sharded(
    mesh: Mesh,
    spec: TreeSpec,
    features: jax.Array,
    rays: Rays,
    opt: RenderOptions,
    axis_name: str = "rays",
) -> jax.Array:
    """jit the volume render with rays sharded / tree replicated. XLA
    GSPMD propagates the shardings through the march loop; no collectives
    are needed in the forward pass."""
    fn = _render_sharded_fn(mesh, axis_name)
    return fn(spec, features, rays.origins, rays.dirs, rays.viewdirs, opt)


@functools.lru_cache(maxsize=None)
def _render_sharded_fn(mesh: Mesh, axis_name: str):
    """Build-once jitted sharded render (a fresh closure per call would
    key a fresh jit cache and re-trace every frame)."""
    ray_sh = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())

    @functools.partial(
        jax.jit,
        static_argnames=("opt",),
        in_shardings=(None, repl, ray_sh, ray_sh, ray_sh),
        out_shardings=ray_sh,
    )
    def _render(spec, features, origins, dirs, vdirs, opt):
        return render_ops.volume_render(spec, features, origins, dirs, vdirs, opt)

    return _render


def make_train_step(
    mesh: Mesh,
    opt: RenderOptions,
    optimizer=None,
    loss_fn: Optional[Callable] = None,
    axis_name: str = "rays",
):
    """Build a jitted distributed training step.

    The step renders a sharded ray batch against the replicated feature
    pool, computes a loss against sharded targets, backprops through the
    hand-written render VJP, and applies an optimizer update. The feature
    gradient is produced by scatter-adds from every shard into the
    replicated (M, D) buffer — GSPMD turns that into per-device partial
    gradients + one `psum` (the entire communication footprint
    of this workload).

    :param optimizer: an optax GradientTransformation (default: sgd(1e-2))
    :param loss_fn: (pred, target) -> scalar; default 0.5*MSE over colors
    :return: step(params_state, spec, rays, target) -> (state, loss)
        where params_state = (features, opt_state)
    """
    import optax

    if optimizer is None:
        optimizer = optax.sgd(1e-2)
    if loss_fn is None:
        loss_fn = lambda pred, tgt: 0.5 * jnp.mean((pred - tgt) ** 2)

    ray_sh = NamedSharding(mesh, P(axis_name))
    repl = NamedSharding(mesh, P())

    def init(features):
        features = jax.device_put(jnp.asarray(features), repl)
        return features, optimizer.init(features)

    @functools.partial(
        jax.jit,
        static_argnames=("opt_static",),
        in_shardings=((repl, repl), None, (ray_sh, ray_sh, ray_sh), ray_sh),
        out_shardings=((repl, repl), repl),
    )
    def step(params_state, spec, rays, target, opt_static=opt):
        features, opt_state = params_state

        def loss_of(f):
            pred = render_ops.volume_render(
                spec, f, rays[0], rays[1], rays[2], opt_static
            )
            return loss_fn(pred, target)

        loss, grads = jax.value_and_grad(loss_of)(features)
        updates, opt_state = optimizer.update(grads, opt_state, features)
        features = optax.apply_updates(features, updates)
        return (features, opt_state), loss

    step.init = init
    return step


# ---------------------------------------------------------------------------
# Recorded-tape replay over a ray mesh
# ---------------------------------------------------------------------------
#
# A RayTape's per-chunk tables are (n_chunks, S, C): sharding the C
# (rays-within-chunk) axis gives tape replay the same data parallelism
# as render_sharded — each device replays its C/n rows of every chunk
# against the replicated feature pool, and the tape-VJP's gradient
# scatter-adds into the replicated pool become per-device partials + one
# GSPMD psum, exactly like the march path. Chunk counts are
# length-homogeneous by construction, so shards stay load-balanced.


def _tape_shardings(mesh: Mesh, tape, axis_name: str = "rays"):
    """Per-leaf NamedShardings for a RayTape: shard the rays-within-
    chunk axis, replicate everything else (dispatch on leaf shape)."""
    C = tape.C
    repl = NamedSharding(mesh, P())

    def sh(x):
        shape = jnp.shape(x)
        if len(shape) == 3 and shape[2] == C:      # (n_chunks, S, C)
            return NamedSharding(mesh, P(None, None, axis_name))
        if len(shape) == 3 and shape[1] == C:      # (n_chunks, C, 3)
            return NamedSharding(mesh, P(None, axis_name, None))
        if len(shape) == 2 and shape[1] == C:      # (n_chunks, C)
            return NamedSharding(mesh, P(None, axis_name))
        return repl                                 # inv_pos etc.

    return jax.tree_util.tree_map(sh, tape)


def shard_tape(mesh: Mesh, tape, axis_name: str = "rays"):
    """Place a RayTape on the mesh with rays-within-chunk sharded
    (requires tape.C % mesh ray-axis size == 0)."""
    assert tape.C % mesh.shape[axis_name] == 0, (
        f"tape chunk size {tape.C} not divisible by mesh axis "
        f"{mesh.shape[axis_name]}"
    )
    return jax.device_put(tape, _tape_shardings(mesh, tape, axis_name))


def replay_sharded(mesh: Mesh, tape, features, opt: RenderOptions,
                   spec=None, axis_name: str = "rays"):
    """Tape replay with the tape ray-sharded / pool replicated (the
    render_sharded counterpart). Output rows come back in ORIGINAL ray
    order (the unsort gather is a GSPMD all-to-all)."""
    from ..ops import tape as tape_ops

    repl = NamedSharding(mesh, P())

    @functools.partial(jax.jit, static_argnames=("opt_",))
    def _replay(tape_, features_, spec_, opt_):
        return tape_ops.replay_render(tape_, features_, opt_, spec_)

    tape = jax.device_put(tape, _tape_shardings(mesh, tape, axis_name))
    features = jax.device_put(jnp.asarray(features), repl)
    return _replay(tape, features, spec, opt)


def make_tape_train_step(
    mesh: Mesh,
    opt: RenderOptions,
    optimizer=None,
    loss_fn: Optional[Callable] = None,
    axis_name: str = "rays",
):
    """Distributed fixed-ray training step over a recorded tape (the
    make_train_step counterpart). Targets are given in
    TAPE order ((n_chunks*C, out_dim) — map with tape.inv_pos) so the
    hot loop needs no unsort gather.

    :return: step(params_state, tape, spec, target) -> (state, loss)
    """
    import optax

    from ..ops import tape as tape_ops

    if optimizer is None:
        optimizer = optax.sgd(1e-2)
    if loss_fn is None:
        loss_fn = lambda pred, tgt: 0.5 * jnp.mean((pred - tgt) ** 2)

    repl = NamedSharding(mesh, P())

    def init(features):
        features = jax.device_put(jnp.asarray(features), repl)
        return features, optimizer.init(features)

    @functools.partial(jax.jit, static_argnames=("opt_static",))
    def step(params_state, tape, spec, target, opt_static=opt):
        features, opt_state = params_state

        def loss_of(f):
            pred = tape_ops.replay_render(
                tape, f, opt_static, spec, unsort=False
            )
            return loss_fn(pred, target)

        loss, grads = jax.value_and_grad(loss_of)(features)
        updates, opt_state = optimizer.update(grads, opt_state, features)
        features = optax.apply_updates(features, updates)
        return (features, opt_state), loss

    step.init = init
    return step


# ---------------------------------------------------------------------------
# Model-parallel feature pool (pool sharding)
# ---------------------------------------------------------------------------
#
# Ray DP replicates the feature pool on every device; scenes whose pool
# (or bf16/int8 pool + optimizer state) outgrows one device's memory need the
# POOL itself sharded. The march's structure tables stay replicated
# (they are the small part) and the pool is row-sharded over a mesh
# axis: every round's feature gather resolves locally (non-owned rows
# read exact zeros) and ONE `lax.psum` over the pool axis assembles the
# true rows before any radiometry — each row is owned by exactly one
# shard, so the reduction moves values, never mixes partial sums. The
# backward needs NO extra communication: every device scatters and keeps
# the gradient rows of its own shard (see RenderOptions.pool_axis and
# ops/render._pool_view). Per-round cost is one (K*B, D) all-reduce over
# the pool axis; combine with a ray axis on a 2-D mesh for DP x MP.


def shard_pool(mesh: Mesh, features, pool_axis: str = "pool"):
    """Row-shard a (M, D) feature pool over `pool_axis` (padding M up to
    a multiple of the axis size). Returns (sharded_padded_pool, M)."""
    n = mesh.shape[pool_axis]
    features = jnp.asarray(features)
    M = features.shape[0]
    pad = (-M) % n
    if pad:
        features = jnp.pad(features, ((0, pad), (0, 0)))
    sh = NamedSharding(mesh, P(pool_axis))
    return jax.device_put(features, sh), M


def unshard_pool(features_padded, M: int):
    """Gather a sharded padded pool back to a host (M, D) array."""
    return np.asarray(jax.device_get(features_padded))[:M]


def shard_baked(mesh: Mesh, baked, axis: str = "pool"):
    """Row-shard a BakedTree's brick atlas over `axis` (huge-scene MP):
    each device stores 1/n of the fine-brick table; one psum per march
    step assembles looked-up entries (ops/bake.py::_brick_gather). The
    top/mid tables and src maps stay replicated (the small part).
    Compose with `shard_pool` on the same axis to shard the feature pool
    too. Returns the sharded BakedTree (brick_axis set); `refresh`
    requires the global bake — refresh, then re-shard."""
    import dataclasses

    from ..ops import bake as bake_ops

    n = mesh.shape[axis]
    brick = np.asarray(jax.device_get(baked.brick))
    pad = (-brick.shape[0]) % n
    if pad:
        brick = np.concatenate([
            brick,
            np.full((pad, brick.shape[1]), bake_ops.EMPTY_ROW, brick.dtype),
        ])
    sh = NamedSharding(mesh, P(axis))
    return dataclasses.replace(
        baked, brick=jax.device_put(jnp.asarray(brick), sh), brick_axis=axis
    )


def _spec_pspecs(spec):
    """Per-leaf PartitionSpecs for a TreeSpec/BakedTree shard_map input:
    everything replicated except a brick atlas marked sharded."""
    import dataclasses

    from ..ops.bake import BakedTree

    specs = jax.tree_util.tree_map(lambda _: P(), spec)
    if isinstance(spec, BakedTree) and spec.brick_axis is not None:
        specs = dataclasses.replace(specs, brick=P(spec.brick_axis))
    return specs


def render_pool_sharded(
    mesh: Mesh,
    spec: TreeSpec,
    features: jax.Array,
    rays: Rays,
    opt: RenderOptions,
    pool_axis: str = "pool",
    ray_axis: Optional[str] = None,
):
    """Volume render with the feature pool row-sharded over `pool_axis`
    and rays optionally sharded over `ray_axis` (2-D DP x MP mesh).

    `features` may be the global (M, D) pool (sharded here) or an
    already `shard_pool`-ed padded pool plus the original M via a
    (pool, M) tuple."""
    import dataclasses

    from jax import shard_map

    if isinstance(features, tuple):
        fshard, M = features
    else:
        fshard, M = shard_pool(mesh, features, pool_axis)
    opt2 = dataclasses.replace(
        opt, pool_axis=pool_axis, pool_rows=M, ray_axis=ray_axis
    )
    key = (mesh, opt2, pool_axis, ray_axis,
           jax.tree_util.tree_structure(spec))
    fn = _POOL_RENDER_CACHE.get(key)
    if fn is None:
        rspec = P(ray_axis) if ray_axis is not None else P()

        def local(spec_, f_, o_, d_, v_):
            return render_ops.volume_render(spec_, f_, o_, d_, v_, opt2)

        fn = jax.jit(shard_map(
            local,
            mesh=mesh,
            in_specs=(_spec_pspecs(spec), P(pool_axis), rspec, rspec, rspec),
            out_specs=rspec,
        ))
        # Build once per (mesh, options, spec structure): a fresh
        # closure per call would key a fresh jit cache and re-trace
        # the whole march every frame.
        _POOL_RENDER_CACHE[key] = fn
    return fn(spec, fshard, rays.origins, rays.dirs, rays.viewdirs)


def make_pool_train_step(
    mesh: Mesh,
    opt: RenderOptions,
    n_features: int,
    optimizer=None,
    loss_fn: Optional[Callable] = None,
    ray_axis: str = "rays",
    pool_axis: str = "pool",
    spec_example=None,
):
    """Distributed training step on a 2-D (ray DP x pool MP) mesh.

    The pool AND its optimizer state live sharded over `pool_axis`
    (1/n-th of the memory per device); rays/targets shard over `ray_axis`.
    Communication per step: the per-round feature-row psum over the pool
    axis (forward + backward re-march) and one ray-axis psum of the pool
    cotangent. The latter is performed MANUALLY inside the custom-VJP
    backward (ops/render.py `_cast`, gated on `opt.ray_axis`) — shard_map
    AD cannot insert collectives into a custom_vjp bwd, so `ray_axis`
    must be threaded into RenderOptions (done below) or gradients come
    back as per-ray-shard partials.

    :param n_features: TRUE global pool row count M (static; the stored
        pool is padded to a multiple of the pool-axis size)
    :return: step(params_state, spec, rays, target) -> (state, loss);
        step.init(features) shards the pool + optimizer state.
    """
    import dataclasses

    import optax
    from jax import shard_map

    if optimizer is None:
        optimizer = optax.sgd(1e-2)
    if loss_fn is None:
        loss_fn = lambda pred, tgt: 0.5 * jnp.mean((pred - tgt) ** 2)

    opt2 = dataclasses.replace(
        opt, pool_axis=pool_axis, pool_rows=n_features, ray_axis=ray_axis
    )
    rspec = P(ray_axis)

    def _render_local(spec_, f_, o_, d_, v_):
        return render_ops.volume_render(spec_, f_, o_, d_, v_, opt2)

    # A brick-sharded BakedTree (shard_baked) needs its brick leaf
    # declared sharded: pass the spec (or any same-structure example)
    # as `spec_example`.
    spec_in = P() if spec_example is None else _spec_pspecs(spec_example)
    render_sm = shard_map(
        _render_local,
        mesh=mesh,
        in_specs=(spec_in, P(pool_axis), rspec, rspec, rspec),
        out_specs=rspec,
    )

    def init(features):
        fshard, M = shard_pool(mesh, features, pool_axis)
        assert M == n_features, (M, n_features)
        return fshard, optimizer.init(fshard)

    @jax.jit
    def step(params_state, spec, rays, target):
        features, opt_state = params_state

        def loss_of(f):
            pred = render_sm(spec, f, rays[0], rays[1], rays[2])
            return loss_fn(pred, target)

        loss, grads = jax.value_and_grad(loss_of)(features)
        updates, opt_state = optimizer.update(grads, opt_state, features)
        features = optax.apply_updates(features, updates)
        return (features, opt_state), loss

    step.init = init
    return step
