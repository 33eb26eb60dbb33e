"""Precomputed ray schedules — cost-ordered chunking.

The march processes rays in fixed chunks whose while-loop exits when the
chunk's SLOWEST ray finishes, so mixed-cost chunks burn straggler
rounds: the sum of chunk round-maxima exceeds the per-ray ideal even
with tile-coherent ordering. Reordering rays by a precomputed per-ray
cost makes chunks cost-HOMOGENEOUS.

Contrast with the reference: a CUDA SIMT renderer gets this from the
hardware (warps retire independently; the scheduler backfills); the
chunked march needs a PRECOMPUTED schedule, amortized across frames
exactly like the bake. Whether it still pays on the GPU is not yet
measured (ROADMAP 3.3). Correctness is unaffected by schedule
quality: per-ray outputs are independent of chunk membership, so any
permutation renders bit-identically (only the weight-accumulation
scatter ORDER changes — ~1 ulp). A plan therefore never goes wrong,
only stale: re-plan when the camera or the scene structure changes
enough to matter.

The cost model is the march's own structure walk (no radiometry): steps
to the clipped tmax honoring the options' cull/advance/skip-box flags.
When early termination is enabled (stop_thresh > 0) and a sigma table
is supplied, the cost march replicates the real transmittance chain
(one extra gather per step) so retire points are predicted for opaque
AND translucent content — a count-occupied-samples proxy misorders
translucent scenes, where rays cross many occupied cells without
stopping. One fused pre-march dispatch + one host argsort.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.spec import RenderOptions
from .render import effective_skip_base


@functools.partial(
    jax.jit,
    static_argnames=("skip_base", "n_rows", "step_size", "max_steps",
                     "interp", "box_advance", "sigma_thresh",
                     "stop_thresh", "chunk"),
)
def march_cost(
    spec,
    origins: jax.Array,
    dirs: jax.Array,
    skip_base: int,
    n_rows: int,
    step_size: float,
    max_steps: int,
    interp: int = 0,
    box_advance: int = 0,
    sigma_thresh: float = 0.0,
    stop_thresh: float = 0.0,
    sigmas: jax.Array = None,
    chunk: int = 0,
) -> jax.Array:
    """Per-ray structure-march step count (B,) int32 — the schedule's
    cost metric. Mirrors the production march's phase-1 walk (same
    lookup, same cull/advance flags); with `sigmas` ((n_rows,) density
    column) and stop_thresh > 0 it also tracks transmittance so early
    ray termination is predicted.

    ``chunk`` > 0 walks the batch in chunks of that many rays (lax.scan
    with a per-chunk while): an unchunked pre-march pays the GLOBAL
    slowest ray's step count for every ray, which made plan builds cost
    ~8-20 rendered frames (round-3 verdict #4). Counts are exactly the
    unchunked ones (the walk is per-ray)."""
    from .render import _clip_to_occupied, _lookup_leaf_xyz, _ray_setup

    use_stop = stop_thresh > 0.0 and sigmas is not None

    def walk(origins_, dirs_):
        o, d, invdir, dscale, tmin, tmax, hit = _ray_setup(
            spec, origins_, dirs_
        )
        tmin, tmax, hit = _clip_to_occupied(
            spec, o, invdir, tmin, tmax, hit, interp, box_advance
        )
        oxyz = (o[:, 0], o[:, 1], o[:, 2])
        dxyz = (d[:, 0], d[:, 1], d[:, 2])
        ivxyz = (invdir[:, 0], invdir[:, 1], invdir[:, 2])

        def body(carry):
            t, act, n, L = carry
            didx, dt, _, _ = _lookup_leaf_xyz(
                spec, oxyz, dxyz, ivxyz, t, step_size, skip_base
            )
            if use_stop:
                occ = didx < n_rows
                sig = jnp.where(occ, sigmas[jnp.where(occ, didx, 0)], 0.0)
                contrib = jnp.logical_and(
                    jnp.logical_and(act, occ), sig > sigma_thresh
                )
                L = jnp.where(contrib, L * jnp.exp(-dt * dscale * sig), L)
            t = jnp.where(act, t + dt, t)
            n = n + act.astype(jnp.int32)
            act = jnp.logical_and(act, t < tmax)
            if use_stop:
                act = jnp.logical_and(act, L > stop_thresh)
            return t, act, n, L

        t0 = jnp.where(hit, tmin, jnp.inf)
        act0 = jnp.logical_and(hit, t0 < tmax)
        z = jnp.zeros_like(t0, dtype=jnp.int32)
        _, _, n, _ = jax.lax.while_loop(
            lambda c: jnp.logical_and(
                jnp.any(c[1]), jnp.max(c[2]) < max_steps
            ),
            body,
            (t0, act0, z, jnp.ones_like(t0)),
        )
        return n

    B = origins.shape[0]
    if chunk <= 0 or B <= chunk:
        return walk(origins, dirs)
    n_chunks = -(-B // chunk)
    pad = n_chunks * chunk - B
    if pad:
        # Padding duplicates ray 0 (any ray works: per-ray counts are
        # independent; padded rows are sliced off below).
        origins = jnp.concatenate([origins, origins[:1].repeat(pad, 0)])
        dirs = jnp.concatenate([dirs, dirs[:1].repeat(pad, 0)])
    o_c = origins.reshape(n_chunks, chunk, 3)
    d_c = dirs.reshape(n_chunks, chunk, 3)
    _, ns = jax.lax.scan(lambda _, xs: (0, walk(*xs)), 0, (o_c, d_c))
    return ns.reshape(-1)[:B]


# Cost pre-march chunk size: spatially coherent (tile/pixel) orders let
# each chunk's while exit at the chunk's own depth instead of the
# global maximum.
_PLAN_CHUNK = 8192


def ray_costs(spec, origins, dirs, opt: RenderOptions, n_rows: int,
              sigmas=None, chunk: int = _PLAN_CHUNK) -> np.ndarray:
    """Host (B,) int32 predicted march costs under these options."""
    # The cost walk must honor exactly the skip boxes the production
    # march honors — shared gate, single definition (render.py).
    skip_base = effective_skip_base(spec, opt)
    if sigmas is not None:
        sigmas = jnp.asarray(sigmas, jnp.float32)
    return np.asarray(
        march_cost(
            spec, origins, dirs, skip_base, int(n_rows),
            float(opt.step_size), int(opt.max_steps), int(opt.interp),
            int(opt.box_advance), float(opt.sigma_thresh),
            float(opt.stop_thresh), sigmas, int(chunk),
        )
    )


def cost_order(spec, origins, dirs, opt: RenderOptions, n_rows: int,
               sigmas=None, chunk: int = _PLAN_CHUNK):
    """Stable cost-sorted ray permutation (host int32 (B,)).

    Stability preserves the input (e.g. tile-coherent) order within
    equal-cost classes, keeping spatial gather locality. Pass `sigmas`
    (the feature pool's density column, (n_rows,)) so plans under
    early-termination options predict where rays retire."""
    n = ray_costs(spec, origins, dirs, opt, n_rows, sigmas, chunk)
    return np.argsort(n, kind="stable").astype(np.int32)
