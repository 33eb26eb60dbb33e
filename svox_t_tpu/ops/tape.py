"""Recorded sample tapes — structure-walk caching for repeated renders.

Per-ray sample sequences (data_idx, delta_t) depend only on the rays,
the tree STRUCTURE, and the march-geometry options — not on the feature
values. Like the cost plan (ops/schedule.py) they are therefore a
per-(rays x structure version x geometry-options) artifact: record them
once, then render any number of frames (training steps, animated
features, quantized pools) by REPLAYING only the radiometry — no
structure gathers, no lane selects, no DDA in the hot loop; the tape is
read back with contiguous dynamic slices and the feature gather is the
only gather left per round.

A tape is a display list for the march. The reference re-walks the
octree every frame, one CUDA thread per ray; here replay skips both the
walk and the march's chunk-straggler waste (rays are re-chunked sorted
by sample count, so chunks are length-homogeneous).

Two tape layouts, chosen at record time:

  * ``compact=False`` — every sample the march takes (empty-leaf
    crossings included), preserving the march's round boundaries.
    Replay is **bit-identical** to `volume_render`: the per-slot values
    entering the radiometry are equal, and slots the march processes
    but the replay skips are all-empty rounds whose updates are exact
    no-ops (att == 1.0 exactly, out_c += 0.0).
  * ``compact=True`` (default) — empty crossings are dropped. An empty
    slot contributes att == exp(-dt*ds*0) == 1.0 EXACTLY, and removing
    an exact 1.0 factor from the attenuation chain preserves every
    product value; what changes is only how the remaining samples group
    into rounds — the same float-regrouping license as changing
    `RenderOptions.round_size` (outputs agree to ~1e-6, tested). The
    sample POSITIONS never move (the t-chain was recorded), so this
    stays inside the CLAUDE.md exact-path rules.

Radiometry parity is structural: the replay round body calls the SAME
`_phase2_radiometry` as the march (ops/render.py), so the two cannot
drift. Trilinear interpolation (`opt.interp`) is not supported on tapes
(interp re-derives 8 corner cells per sample from positions — a
structure walk); record/replay assert it off.

**Data-indirect (cell-indexed) tapes** (``indirect=True``) survive
`construct_tree` re-pointing — the "t" in svox_t. Sample POSITIONS
depend only on tree structure (which the dynamic frame loop never
edits; construct_tree rewrites only the index table,
svox_kernel.cu:110-121), so the tape stores the flat TREE-CELL id per
sample instead of a frozen feature row; replay resolves
``data_idx = index_table[cell]`` with one extra row-gather from the
CURRENT frame's (packed) index table — a small loop-invariant
operand — then proceeds unchanged. Occupancy changes per frame,
so compaction/ray-ordering must be keyed on a CONSERVATIVE occupancy:
record against the UNION index table (occupancy only grows across a
construct_tree sequence — stale pointers persist — so the union is the
final table of a pre-pass over the animation) and the union cull box.
Replayed outputs then equal the per-frame march exactly: slots beyond a
frame's own occupancy are att == 1.0 no-ops (empty in that frame), and
rays outside a frame's own box march through cells empty in that frame
(background, bitwise). Guards key on structure, not occupancy.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.spec import DATA_SENTINEL, FORMAT_RGBA, RenderOptions
from .bake import BakedTree
from .render import (QuantizedFeatures, _basis_window, _clip_to_occupied,
                     _march_round, _phase2_radiometry, _pool_view,
                     _ray_setup, _round_grad_rows, _round_sigma,
                     _scatter_add_compact, _scatter_to_local,
                     effective_skip_base, get_out_data_dim)
from .sh import eval_basis


class _NoSpec:
    """Stand-in when no spec is supplied at replay: no per-voxel
    transformation matrices, no SG/ASG extra data."""

    transformation_matrices = None
    extra_data = None


_NOSPEC = _NoSpec()

# Bulk-flush ys safety cap (see _replay_bwd_impl): beyond this the
# backward auto-falls back to the tiered per-round scatter. Not yet
# re-sized for the GPU's memory (ROADMAP 1.7).
_BULK_YS_MAX_BYTES = 1 << 30


def _geom_key(spec, opt: RenderOptions) -> tuple:
    """The options that determine sample POSITIONS (the recorded
    t-chain). Tapes are valid only under the exact geometry they were
    recorded with; everything else (thresholds, background, basis
    window) is replay-time radiometry."""
    return (
        float(opt.step_size), int(opt.max_steps), int(opt.box_advance),
        int(effective_skip_base(spec, opt)), int(opt.interp),
    )


def _check_geom(tape, spec, opt: RenderOptions):
    if not tape.geom:
        return
    if spec is not None:
        key = _geom_key(spec, opt)
    else:
        # No spec at replay: the skip-base slot cannot be recomputed;
        # check the opt-derived geometry only.
        key = (float(opt.step_size), int(opt.max_steps),
               int(opt.box_advance), tape.geom[3], int(opt.interp))
    if key != tape.geom:
        raise ValueError(
            f"tape was recorded under geometry {tape.geom} but replay "
            f"options give {key} — sample positions would not match; "
            "re-record the tape"
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RayTape:
    """A recorded march: per-chunk (S, C) sample tables + per-ray ray
    constants, rays sorted by sample count (length-homogeneous chunks).

    Data fields (leaves):
      idx:    (n_chunks, S, C) int32 — feature-row index per sample;
              values >= n_features (incl. DATA_SENTINEL padding) are
              empty space, exactly as in the march.
      dt:     (n_chunks, S, C) f32 — per-sample step length (recorded
              t-chain; never recomputed).
      cell:   (n_chunks, S, C) int32 or None — flat TREE-CELL id per
              sample (src_map-resolved for baked specs) for weight
              accumulation.
      counts: (n_chunks, C) int32 — valid samples per ray (replay loop
              bound).
      origins/dirs/vdirs: (n_chunks, C, 3) f32 — the permuted rays (for
              basis evaluation and the backward fallback).
      dscale: (n_chunks, C) f32 — per-ray delta_scale.
      inv_pos:(n_rays,) int32 — position of original ray i in the
              sorted+padded layout (output unsort gather).

    Meta (static): n_rays, chunk size C, tape width S, compact flag,
    n_features bound at record time, n_cells (weight-accum table size),
    record round size.
    """

    idx: jax.Array
    dt: jax.Array
    cell: Optional[jax.Array]
    counts: jax.Array
    origins: jax.Array
    dirs: jax.Array
    vdirs: jax.Array
    dscale: jax.Array
    inv_pos: jax.Array
    # Flat round PROGRAMS (host-built at record time): the exact-mode
    # replay is a lax.scan of exactly these rounds — no while conds, no
    # carried output buffer. round_chunk/round_s0 are (R,) int32
    # per-round (chunk - n_zero, sample offset) at the record round
    # size; R is padded to a coarse ladder with provable no-op rounds
    # (s0 past every count -> valid all-false, idempotent ys) so
    # executables are reused across cameras. last_round
    # (n_chunks - n_zero,) marks each chunk's final round; its ys row is
    # that chunk's output. The bwd_* program is the same thing at the
    # backward round size.
    round_chunk: jax.Array
    round_s0: jax.Array
    last_round: jax.Array
    bwd_round_chunk: jax.Array
    bwd_round_s0: jax.Array
    n_rays: int = dataclasses.field(metadata=dict(static=True))
    C: int = dataclasses.field(metadata=dict(static=True))
    S: int = dataclasses.field(metadata=dict(static=True))
    compact: bool = dataclasses.field(metadata=dict(static=True))
    n_features: int = dataclasses.field(metadata=dict(static=True))
    n_cells: int = dataclasses.field(metadata=dict(static=True))
    # March-geometry key the tape was recorded under (sample POSITIONS
    # depend on these; radiometry options are free to vary per replay).
    geom: tuple = dataclasses.field(
        default=(), metadata=dict(static=True)
    )
    # Leading all-empty chunks (every ray has ZERO occupied samples):
    # rays are ordered zero-occupancy-first, so these form a contiguous
    # prefix whose replay output is EXACTLY the background row (bitwise:
    # L stays 1.0, out_c stays 0.0, finalize gives bg / alpha 0) — the
    # replay skips their scan steps entirely and broadcasts the
    # constant. On background-dominated scenes this is most of the
    # replay's loop plumbing (the headline shell: 286 of 313 chunks).
    n_zero: int = dataclasses.field(
        default=0, metadata=dict(static=True)
    )
    # Round sizes the two programs were built for (replay requires a
    # matching opt.round_size / bwd_round_size — the program IS the
    # round structure).
    prog_K: int = dataclasses.field(
        default=4, metadata=dict(static=True)
    )
    bwd_prog_K: int = dataclasses.field(
        default=8, metadata=dict(static=True)
    )
    # Output-order mapping granularity. When `group` > 1 the count sort
    # moved GROUPS of `group` consecutive input rays (spatially coherent
    # => count-homogeneous), so the output unsort is a gather of
    # n_rays/group contiguous G-row blocks (`ginv`: padded-layout block
    # position of input block g) instead of n_rays single-row gathers.
    # `inv_pos` stays valid
    # either way (ray-level addressing for unsort=False consumers).
    ginv: Optional[jax.Array] = None
    # Per-sample march parameter t (the recorded t-chain value AT the
    # sample), present when recorded with ``record_t=True``: the
    # first-hit depth replay (`replay_depth`) selects each ray's first
    # over-threshold resident sample and reads its t here. Pure
    # structure — frame-invariant, so data-indirect tapes keep it
    # across construct_tree re-points.
    tval: Optional[jax.Array] = None
    group: int = dataclasses.field(default=1, metadata=dict(static=True))
    # Optional 2-D pixel-block layout (nbh, nbw, bh, bw) per image, set
    # by the perspective recorders: rays were recorded in block-major
    # order (group == bh*bw), and the unsort finishes with a pure
    # reshape/transpose from block-major back to raster order. Small
    # square-ish blocks are more count-coherent than scanline runs of
    # the same size (fewer program rounds).
    out_blocks: tuple = dataclasses.field(
        default=(), metadata=dict(static=True)
    )
    # Data-indirect (cell-indexed) tape: `idx` holds flat TREE-CELL ids
    # (indices into the tree's index table) instead of feature rows;
    # replay requires the frame's packed index table and resolves
    # data_idx per sample (see module docstring). Survives
    # construct_tree re-pointing; compaction/counts were keyed on the
    # UNION occupancy the tape was recorded against.
    indirect: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )

    @property
    def n_chunks(self) -> int:
        return self.idx.shape[0]

    @property
    def n_samples(self) -> int:
        """Live samples recorded (host sum of counts)."""
        return int(np.asarray(jnp.sum(self.counts)))


@functools.partial(
    jax.jit,
    static_argnames=("skip_base", "n_rows", "step_size", "max_steps",
                     "box_advance"),
)
def _count_samples(spec, origins, dirs, skip_base, n_rows, step_size,
                   max_steps, box_advance):
    """Per-ray (occupied, total) sample counts — the tape-ordering walk.
    Mirrors the march's phase-1 chain (same lookup, same cull/advance)."""
    from .render import _lookup_leaf_xyz

    o, d, invdir, dscale, tmin, tmax, hit = _ray_setup(spec, origins, dirs)
    tmin, tmax, hit = _clip_to_occupied(
        spec, o, invdir, tmin, tmax, hit, 0, box_advance
    )
    oxyz = (o[:, 0], o[:, 1], o[:, 2])
    dxyz = (d[:, 0], d[:, 1], d[:, 2])
    ivxyz = (invdir[:, 0], invdir[:, 1], invdir[:, 2])

    def body(carry):
        t, act, n_occ, n_tot = carry
        didx, dt, _, _ = _lookup_leaf_xyz(
            spec, oxyz, dxyz, ivxyz, t, step_size, skip_base
        )
        occ = jnp.logical_and(act, didx < n_rows)
        n_occ = n_occ + occ.astype(jnp.int32)
        n_tot = n_tot + act.astype(jnp.int32)
        t = jnp.where(act, t + dt, t)
        act = jnp.logical_and(act, t < tmax)
        return t, act, n_occ, n_tot

    t0 = jnp.where(hit, tmin, jnp.inf)
    act0 = jnp.logical_and(hit, t0 < tmax)
    z = jnp.zeros_like(t0, jnp.int32)
    _, _, n_occ, n_tot = jax.lax.while_loop(
        lambda c: jnp.logical_and(jnp.any(c[1]), jnp.max(c[3]) < max_steps),
        body,
        (t0, act0, z, z),
    )
    return n_occ, n_tot


@functools.partial(
    jax.jit,
    static_argnames=("opt", "S_rec", "S_out", "n_features", "record_cells",
                     "compact", "record_t"),
)
def _record_chunks(spec, origins_c, dirs_c, opt: RenderOptions, S_rec: int,
                   S_out: int, n_features: int, record_cells: bool,
                   compact: bool, record_t: bool = False):
    """Record march: scan chunks, run the EXACT march chain
    (`_march_round` — the same function the renderer marches with), and
    write each round's (K, C) sample block into the chunk's (S_rec, C)
    buffers; compaction (if requested) is a stable per-column sort that
    brings occupied samples to the front in order."""
    K = max(1, opt.round_size)
    is_baked = isinstance(spec, BakedTree)

    def chunk(_, xs):
        origins_, dirs_ = xs
        C = origins_.shape[0]
        o, d, invdir, dscale, tmin, tmax, hit = _ray_setup(
            spec, origins_, dirs_
        )
        tmin, tmax, hit = _clip_to_occupied(
            spec, o, invdir, tmin, tmax, hit, opt.interp, opt.box_advance
        )
        oxyz = (o[:, 0], o[:, 1], o[:, 2])
        dxyz = (d[:, 0], d[:, 1], d[:, 2])
        ivxyz = (invdir[:, 0], invdir[:, 1], invdir[:, 2])

        idx_b = jnp.full((S_rec, C), DATA_SENTINEL, jnp.int32)
        dt_b = jnp.zeros((S_rec, C), origins_.dtype)
        cell_b = jnp.zeros((S_rec, C), jnp.int32)
        t_b = jnp.zeros((S_rec, C), origins_.dtype)

        def cond(carry):
            step0, t, active = carry[0], carry[1], carry[2]
            return jnp.logical_and(step0 < opt.max_steps, jnp.any(active))

        def body(carry):
            step0, t, active, idx_b, dt_b, cell_b, t_b, n_valid = carry
            idx, dt, valid, cell, t_at, _, t_end, act_end = _march_round(
                spec, opt, oxyz, dxyz, ivxyz, tmax, step0, t, active,
                want_pos=bool(record_t),
            )
            node = (
                spec.src_map[cell.reshape(-1)].reshape(cell.shape)
                if is_baked else cell
            )
            idx_b = jax.lax.dynamic_update_slice(
                idx_b, jnp.where(valid, idx, DATA_SENTINEL), (step0, 0)
            )
            dt_b = jax.lax.dynamic_update_slice(dt_b, dt, (step0, 0))
            if record_cells:
                cell_b = jax.lax.dynamic_update_slice(
                    cell_b, jnp.where(valid, node, 0), (step0, 0)
                )
            if record_t:
                t_b = jax.lax.dynamic_update_slice(t_b, t_at, (step0, 0))
            n_valid = n_valid + jnp.sum(valid, axis=0, dtype=jnp.int32)
            return (step0 + K, t_end, act_end, idx_b, dt_b, cell_b, t_b,
                    n_valid)

        init = (
            jnp.zeros((), jnp.int32), tmin, hit, idx_b, dt_b, cell_b, t_b,
            jnp.zeros((C,), jnp.int32),
        )
        _, _, _, idx_b, dt_b, cell_b, t_b, n_valid = jax.lax.while_loop(
            cond, body, init
        )

        if compact and n_features:
            # compact: stable per-column sort brings occupied samples to
            # the front in order. ONE multi-operand lax.sort co-sorts
            # idx/dt/cell with the occupancy key (no argsort +
            # take_along_axis gathers).
            # Rows past a column's occupied count hold the (sorted-back)
            # empty samples, whose idx is >= n_features by definition —
            # exactly the replay's empty test; no sentinel masking
            # needed.
            occ = idx_b < n_features
            key = jnp.logical_not(occ).astype(jnp.int32)
            ops = (key, idx_b, dt_b)
            ops += (cell_b,) if record_cells else ()
            ops += (t_b,) if record_t else ()
            sorted_ops = jax.lax.sort(
                ops, dimension=0, is_stable=True, num_keys=1
            )
            idx_o = sorted_ops[1][:S_out]
            dt_o = sorted_ops[2][:S_out]
            cell_o = sorted_ops[3][:S_out] if record_cells else cell_b[:S_out]
            t_o = sorted_ops[-1][:S_out] if record_t else t_b[:S_out]
            counts = jnp.sum(occ, axis=0, dtype=jnp.int32)
        else:
            idx_o, dt_o, cell_o, t_o = (
                idx_b[:S_out], dt_b[:S_out], cell_b[:S_out], t_b[:S_out]
            )
            # S_out == S_rec >= every n_valid on the true uncompacted
            # path; the clamp only bites on the degenerate compact
            # empty-pool route (all samples empty — harmless no-ops).
            counts = jnp.minimum(n_valid, S_out)
        if not record_cells:
            cell_o = jnp.zeros((0, C), jnp.int32)
        if not record_t:
            t_o = jnp.zeros((0, C), origins_.dtype)
        return 0, (idx_o, dt_o, cell_o, t_o, counts, dscale)

    _, ys = jax.lax.scan(chunk, 0, (origins_c, dirs_c))
    return ys


def _round_program(caps, K: int, s0_pad: int, r_mult: int = 8):
    """Host-built flat round program over non-empty chunks: per round a
    (chunk, s0) pair; padded to a multiple of ``r_mult`` with no-op
    rounds (s0 = s0_pad, past every per-ray count — the padded rounds
    change nothing and rewrite an identical ys row). The default pad is
    deliberately FINE (8): pad rounds run the full round body (their
    gathers still execute), and a coarse _size_bucket ladder would add
    whole rounds when the true count crossed a bucket edge; executable
    reuse across cameras is NOT the ladder's
    to buy here — the chunk count (n_chunks - n_zero) is a static shape
    that already varies per camera. Row-subset replays (tape_subset.py)
    pass a COARSER r_mult: there the chunk count is batch-size-stable
    and the round count is the one static that would otherwise
    recompile per minibatch."""
    chunk_ids, s0s, last = [], [], []
    for c, cap in enumerate(caps):
        r = max(1, -(-int(cap) // K))
        chunk_ids.extend([c] * r)
        s0s.extend(range(0, r * K, K))
        last.append(len(chunk_ids) - 1)
    R = max(r_mult, -(-len(chunk_ids) // r_mult) * r_mult)
    n_pad = R - len(chunk_ids)
    tail_c = caps.shape[0] - 1 if len(caps) else 0
    chunk_ids.extend([tail_c] * n_pad)
    s0s.extend([int(s0_pad)] * n_pad)
    return (
        jnp.asarray(np.asarray(chunk_ids, np.int32)),
        jnp.asarray(np.asarray(s0s, np.int32)),
        jnp.asarray(np.asarray(last, np.int32)),
    )


def _size_bucket(n: int, lo: int = 8) -> int:
    """Round a tape width up to a coarse ladder (~1.5x steps, multiples
    of 8). S is a STATIC shape of the record/replay executables; exact
    per-camera widths would recompile on every new camera, the ladder
    makes executables reusable at <=50% extra (idle) tape rows — the
    replay loop still exits at the true per-chunk cap."""
    v = lo
    while v < n:
        v = ((v * 3 // 2) + 7) & ~7
    return v


def record_tape(spec, n_features: int, origins, dirs, vdirs,
                opt: RenderOptions, *, compact: bool = True,
                record_cells: bool = True,
                chunk_size: int = 0,
                prog_round_size: int = 0,
                group_size: int = 1,
                indirect: bool = False,
                record_t: bool = False) -> RayTape:
    """Record a :class:`RayTape` for these rays against this structure.

    The tape is valid while the tree STRUCTURE and the march-geometry
    options (step_size, max_steps, box_advance, skip boxes, cull box)
    are unchanged; feature VALUES are free to change between replays
    (that is the point). `n_features` is the feature-pool row bound
    (the occupied/empty split). `chunk_size` defaults to
    ``opt.chunk_size``.

    Cost: two march-speed dispatches (count walk + record walk) plus a
    host argsort — the same amortization class as ``plan_rays``.

    ``group_size`` > 1 sorts GROUPS of that many consecutive input rays
    instead of single rays (groups must divide both the ray count and
    the chunk size, else the size degrades to the largest divisor):
    spatially coherent inputs (scanline/pixel order) keep groups
    count-homogeneous, and the output unsort becomes a cheap
    block gather (see RayTape.group).

    ``indirect=True`` records a data-indirect (cell-indexed) tape that
    survives `construct_tree` re-pointing: `spec` must carry the UNION
    occupancy over every frame the tape will serve (union index table +
    union cull box — conservative compaction/ordering; see the module
    docstring), and replays take the frame's packed index table.

    ``record_t=True`` additionally records each sample's march
    parameter t (`RayTape.tval`, +1 f32 per sample), enabling the
    first-hit depth replay (:func:`replay_depth`).
    """
    if opt.interp:
        raise ValueError("tapes do not support opt.interp (corner cells "
                         "would need a structure walk at replay)")
    if indirect:
        # Cell-indexed tapes: idx IS the cell stream; sample positions
        # must not depend on record-time occupancy details beyond the
        # conservative cull (box_advance/skip boxes shift positions by
        # occupancy, which changes per frame).
        record_cells = True
        if opt.box_advance or effective_skip_base(spec, opt):
            raise ValueError(
                "indirect tapes require exact geometry (box_advance=0, "
                "skip_boxes off): occupancy-driven position shifts do "
                "not survive re-pointing"
            )
    origins = jnp.asarray(origins)
    dirs = jnp.asarray(dirs)
    vdirs = jnp.asarray(vdirs)
    B = origins.shape[0]
    K = max(1, opt.round_size)
    C = int(chunk_size) if chunk_size else int(opt.chunk_size)
    C = max(1, min(C, B))

    skip_base = effective_skip_base(spec, opt)
    n_occ, n_tot = _count_samples(
        spec, origins, dirs, skip_base, int(n_features),
        float(opt.step_size), int(opt.max_steps), int(opt.box_advance),
    )
    # Host fetches: the ordering key(s) + a scalar record-buffer bound.
    n_occ_host = np.asarray(n_occ)
    counts_host = n_occ_host if compact else np.asarray(n_tot)
    n_tot_max = int(jnp.max(n_tot))

    # Zero-occupancy rays FIRST (their replay output is exactly the
    # background — whole chunks of them are skipped statically), then
    # count-sorted for length-homogeneous chunks. Stable in both keys.
    G = max(1, int(group_size))
    while G > 1 and (B % G or C % G):
        G -= 1
    if G > 1:
        # Group-granular sort: a group's key is its WORST ray (the max
        # drives chunk padding); a group is zero-occupancy only if every
        # ray in it is. Within a group, input order is preserved, so the
        # padded layout holds each input block contiguously.
        key_g = counts_host.reshape(-1, G).max(axis=1)
        occ_g = (n_occ_host.reshape(-1, G) > 0).any(axis=1)
        gorder = np.lexsort((key_g, occ_g)).astype(np.int64)
        order = (gorder[:, None] * G + np.arange(G)).reshape(-1)
    else:
        order = np.lexsort((counts_host, n_occ_host > 0)).astype(np.int64)
    Bp = ((B + C - 1) // C) * C
    pad = Bp - B
    # Padding rays duplicate the cheapest real ray; their counts are
    # whatever that ray's count is — harmless (extra masked-out slots).
    order_p = np.concatenate([order[:1].repeat(pad), order])
    n_chunks = Bp // C

    S_rec = int(-(-_size_bucket(max(n_tot_max, K)) // K) * K)
    cap = int(counts_host.max())
    S_out = int(max(K, _size_bucket(max(cap, 1))))
    if not compact:
        S_out = S_rec

    # Leading chunks whose every ray has zero OCCUPIED samples: skipping
    # them is bit-exact in BOTH layouts (all their tape slots are empty
    # -> every round is an exact no-op -> finalize == the background
    # row). Pad rays duplicate order[0] (minimal occupancy) so padding
    # never breaks the prefix.
    occ_p = np.concatenate(
        [n_occ_host[order[:1]].repeat(pad), n_occ_host[order]]
    )
    chunk_has_occ = occ_p.reshape(n_chunks, C).max(axis=1) > 0
    n_zero = int(np.argmax(chunk_has_occ)) if chunk_has_occ.any() else (
        n_chunks
    )

    # Flat round programs (fwd at the record round size, bwd at the
    # backward default) over the non-empty chunks.
    cnt_p = np.concatenate(
        [counts_host[order[:1]].repeat(pad), counts_host[order]]
    )
    caps_nz = np.minimum(
        cnt_p.reshape(n_chunks, C).max(axis=1), S_out
    )[n_zero:]
    # Replay round size (the program IS the round structure). For the
    # bit-exact uncompacted layout it must equal the march's round size;
    # compact tapes carry the regroup license and use K=8 (fewer loop
    # iterations; not yet measured on the GPU, ROADMAP 1.7).
    if prog_round_size:
        K_prog = int(prog_round_size)
    else:
        K_prog = K if not compact else 8
    K_bwd = max(1, opt.bwd_round_size or 8)
    rc, rs, lr = _round_program(caps_nz, K_prog, int(S_out))
    brc, brs, _ = _round_program(caps_nz, K_bwd, int(S_out))

    o_p = origins[jnp.asarray(order_p)]
    d_p = dirs[jnp.asarray(order_p)]
    v_p = vdirs[jnp.asarray(order_p)]
    o_c = o_p.reshape(n_chunks, C, 3)
    d_c = d_p.reshape(n_chunks, C, 3)

    idx, dt, cell, tval, counts, dscale = _record_chunks(
        spec, o_c, d_c, opt, S_rec, S_out, int(n_features),
        bool(record_cells), bool(compact), bool(record_t),
    )

    # position of original ray i in the sorted+padded layout (pad
    # duplicates occupy rows [0, pad) and are never addressed: every
    # original ray appears exactly once in order_p[pad:])
    inv = np.empty(B, np.int64)
    inv[order_p[pad:]] = np.arange(pad, Bp)
    if G > 1:
        # padded-layout BLOCK position of input block g (pad is a
        # multiple of G because G | C and G | B).
        ginv_np = np.empty(B // G, np.int64)
        ginv_np[gorder] = np.arange(pad // G, Bp // G)
        ginv = jnp.asarray(ginv_np.astype(np.int32))
    else:
        ginv = None

    is_baked = isinstance(spec, BakedTree)
    n_cells = int(
        spec.n_tree_cells if is_baked else spec.child_flat.shape[0]
    )
    if indirect:
        # The cell stream IS the sample stream: alias it into `idx`
        # (same device buffer — replays slice one array and resolve
        # data rows through the frame's index table).
        idx = cell
    return RayTape(
        idx=idx, dt=dt, cell=(cell if record_cells else None),
        counts=counts,
        origins=o_c, dirs=d_c, vdirs=v_p.reshape(n_chunks, C, 3),
        dscale=dscale, inv_pos=jnp.asarray(inv.astype(np.int32)),
        n_rays=int(B), C=int(C), S=int(S_out), compact=bool(compact),
        n_features=int(n_features), n_cells=n_cells,
        geom=_geom_key(spec, opt),
        n_zero=n_zero,
        round_chunk=rc, round_s0=rs, last_round=lr,
        bwd_round_chunk=brc, bwd_round_s0=brs,
        prog_K=int(K_prog), bwd_prog_K=int(K_bwd),
        ginv=ginv, group=int(G),
        tval=(tval if record_t else None),
        indirect=bool(indirect),
    )


def pack_index_table(data_flat, width: int = 32):
    """Pack a flat int32 index table into the (rows, width) row-gather
    layout data-indirect replays resolve cells through. Call ONCE per
    frame, OUTSIDE replay loops — the packed table is then a
    loop-invariant operand."""
    data_flat = jnp.asarray(data_flat, jnp.int32).reshape(-1)
    pad = (-data_flat.shape[0]) % width
    if pad:
        data_flat = jnp.concatenate(
            [data_flat, jnp.full((pad,), DATA_SENTINEL, jnp.int32)]
        )
    return data_flat.reshape(-1, width)


def _resolve_cells(index_table, cells):
    """Per-sample data_idx for a round of recorded tree-cell ids: one
    row-gather + lane select through the frame's packed index table.
    Negative entries (legacy tables) read as empty."""
    from .bake import _row_gather

    idx = _row_gather(index_table, cells)
    return jnp.where(idx < 0, jnp.int32(DATA_SENTINEL), idx)


def _check_indirect(tape: RayTape, index_table):
    if tape.indirect and index_table is None:
        raise ValueError(
            "data-indirect tape: pass index_table "
            "(pack_index_table(data_flat) of the frame to render)"
        )
    if index_table is not None and not tape.indirect:
        raise ValueError(
            "index_table passed but the tape was not recorded with "
            "indirect=True"
        )
    if tape.indirect:
        # Structure guard (the data-version axis is free — that is the
        # point of indirection — but a STRUCTURE change resizes the
        # cell space and silently mis-routes every resolve).
        n = int(index_table.shape[0]) * int(index_table.shape[1])
        w = int(index_table.shape[1])
        if not (tape.n_cells <= n < tape.n_cells + w):
            raise ValueError(
                f"index table covers {n} cells (padded, width {w}) but "
                f"the tape was recorded against {tape.n_cells} — the "
                "tree STRUCTURE changed; re-record the tape"
            )


def _pad_tape_to_round(tape: RayTape, K: int):
    """Pad the sample axis to a multiple of K so every dynamic slice is
    in-bounds (a clamped out-of-bounds slice would re-read earlier
    rows). One cheap pad per dispatch, usually compiled away."""
    S = tape.S
    Sp = max(K, -(-S // K) * K)
    if Sp == S:
        return tape.idx, tape.dt, tape.cell, Sp
    padw = ((0, 0), (0, Sp - S), (0, 0))
    # Indirect tapes hold CELL ids: pad with cell 0 (pad slots are past
    # every count and masked; cell 0 keeps the resolve gather in range).
    fill = 0 if tape.indirect else int(DATA_SENTINEL)
    idx = jnp.pad(tape.idx, padw, constant_values=fill)
    dt = jnp.pad(tape.dt, padw)
    cell = jnp.pad(tape.cell, padw) if tape.cell is not None else None
    return idx, dt, cell, Sp


def _replay_fwd_impl(tape: RayTape, features, opt: RenderOptions,
                     spec=None, want_weight_accum: bool = False,
                     index_table=None):
    """Replay radiometry over a recorded tape. Returns ((Bp, n_color+1)
    outputs in TAPE order, waccum or None). `spec` is only needed for
    per-voxel transformation matrices / SG-ASG extra_data.
    `index_table` (data-indirect tapes only) is the frame's packed index
    table; per round, recorded cell ids resolve to data rows through it
    (see module docstring)."""
    if opt.interp:
        raise ValueError("tapes do not support opt.interp")
    _check_indirect(tape, index_table)
    _check_geom(tape, spec, opt)
    if (opt.pool_axis is None
            and not isinstance(features, QuantizedFeatures)
            and features.shape[0] != tape.n_features):
        raise ValueError(
            f"feature pool has {features.shape[0]} rows but the tape was "
            f"recorded against {tape.n_features} — the structure changed; "
            "re-record the tape"
        )
    D = (
        features.q.shape[1]
        if isinstance(features, QuantizedFeatures) else features.shape[1]
    )
    n_color = get_out_data_dim(opt.format, opt.basis_dim, D) - 1
    # The replay round size comes from the TAPE (its flat program bakes
    # the round structure in); opt.round_size plays no role here.
    K = max(1, tape.prog_K)
    C = tape.C
    spec_v = spec if spec is not None else _NOSPEC
    features_t = _pool_view(features, opt, spec)
    dtype = tape.dt.dtype
    can_stop = opt.stop_thresh > 0.0
    idx_t, dt_t, cell_t, Sp = _pad_tape_to_round(tape, K)
    if want_weight_accum:
        if tape.cell is None:
            raise ValueError("tape recorded with record_cells=False")
        waccum0 = jnp.zeros((tape.n_cells,), dtype)
    else:
        waccum0 = jnp.zeros((1,), dtype)
    slot_k = jnp.arange(K, dtype=jnp.int32)
    bg = opt.background_brightness

    # Skip the leading all-empty chunks: their replay output is exactly
    # the background row (zero-occupancy rays were sorted to the front),
    # and on background-dominated scenes they are most of the work (286
    # of 313 chunks on the headline shell).
    nz = tape.n_zero
    NC = tape.n_chunks - nz
    bg_row = jnp.asarray([bg] * n_color + [0.0], dtype)
    if NC == 0:
        out_flat = jnp.broadcast_to(
            bg_row, (tape.n_chunks * C, n_color + 1)
        )
        return out_flat, (waccum0 if want_weight_accum else None)

    idx_t = idx_t[nz:]
    dt_t = dt_t[nz:]
    cell_t = cell_t[nz:] if want_weight_accum else None
    counts_t = tape.counts[nz:]
    ds_t = tape.dscale[nz:]
    caps_t = jnp.max(counts_t, axis=1)
    window = (
        jnp.asarray(_basis_window(opt))
        if opt.format != FORMAT_RGBA else None
    )
    vd_t = tape.vdirs[nz:]

    if not can_stop or opt.tape_stop_program:
        # Flat round PROGRAM replay with ONE lax.scan — no while conds,
        # no carried output buffer (each round's finalized chunk state
        # is a ys row; a chunk's LAST round's row is its output). The
        # round count is structure-bound and data-independent, so the
        # program is exact; padded no-op rounds only rewrite an
        # identical row, and no while-loop cond or carry routing runs.
        # Early-stop
        # modes (opt-in via opt.tape_stop_program) carry the stop mask
        # through the scan: post-stop rounds mask `valid` to all-false
        # and rewrite idempotent rows — outputs bitwise identical to
        # the retiring while below, which stays the stop-mode default
        # because skipping retired chunks beat the cheaper round body
        # on every benchmark scene (see RenderOptions.tape_stop_program).
        def body(carry, xs):
            L, out_c, alpha, stopped, waccum = carry
            c, s0 = xs
            first = s0 == 0
            L = jnp.where(first, 1.0, L)
            out_c = jnp.where(first, 0.0, out_c)
            idx = jax.lax.dynamic_slice(idx_t, (c, s0, 0), (1, K, C))[0]
            if tape.indirect:
                idx = _resolve_cells(index_table, idx)
            dt = jax.lax.dynamic_slice(dt_t, (c, s0, 0), (1, K, C))[0]
            counts = jax.lax.dynamic_slice(counts_t, (c, 0), (1, C))[0]
            ds = jax.lax.dynamic_slice(ds_t, (c, 0), (1, C))[0]
            vd = jax.lax.dynamic_slice(vd_t, (c, 0, 0), (1, C, 3))[0]
            base_basis = (
                eval_basis(opt.format, opt.basis_dim, vd,
                           spec_v.extra_data) * window
                if opt.format != FORMAT_RGBA else None
            )
            valid = (s0 + slot_k)[:, None] < counts[None]
            if can_stop:
                alpha = jnp.where(first, 0.0, alpha)
                stopped = jnp.logical_and(
                    stopped, jnp.logical_not(first)
                )
                valid = jnp.logical_and(
                    valid, jnp.logical_not(stopped)[None]
                )
                act_end = counts > (s0 + K)
            else:
                act_end = stopped  # unused dummy
            if want_weight_accum:
                node_flat = jax.lax.dynamic_slice(
                    cell_t, (c, s0, 0), (1, K, C)
                )[0].reshape(-1)
            else:
                node_flat = None
            L, out_c, alpha, _, stopped, waccum = _phase2_radiometry(
                spec_v, features_t, opt, None, None, vd, base_basis,
                window, ds, n_color, K, dtype, can_stop,
                idx, dt, valid, None, None, node_flat,
                L, out_c, alpha, act_end, stopped, waccum,
                want_weight_accum=want_weight_accum,
                n_cells=tape.n_cells,
            )
            if can_stop:
                fin = jnp.where(
                    stopped[:, None], out_c, out_c + (L * bg)[:, None]
                )
                alpha_f = jnp.where(stopped, alpha, 1.0 - L)
            else:
                fin = out_c + (L * bg)[:, None]
                alpha_f = 1.0 - L
            fin = jnp.concatenate([fin, alpha_f[:, None]], axis=-1)
            return (L, out_c, alpha, stopped, waccum), fin

        per_ray = (C,) if can_stop else (1,)
        init = (
            jnp.ones((C,), dtype),
            jnp.zeros((C, n_color), dtype),
            jnp.zeros(per_ray, dtype),
            jnp.zeros(per_ray, bool),
            waccum0,
        )
        (_, _, _, _, waccum), ys = jax.lax.scan(
            body, init, (tape.round_chunk, tape.round_s0)
        )
        out_flat = ys[tape.last_round].reshape(NC * C, n_color + 1)
        if nz:
            out_flat = jnp.concatenate(
                [jnp.broadcast_to(bg_row, (nz * C, n_color + 1)),
                 out_flat]
            )
        return out_flat, (waccum if want_weight_accum else None)

    # Early-stop modes: ONE flat while over global rounds (the stop can
    # retire a chunk before its structure-bound round count, which a
    # fixed program cannot) — slice each round directly from the full
    # tape arrays and write each chunk's finalized rows into a carried
    # output buffer (in-place dynamic_update_slice).
    def cond(carry):
        return carry[0] < NC

    def body(carry):
        c, s0, L, out_c, alpha, stopped, out_buf, waccum = carry
        idx = jax.lax.dynamic_slice(idx_t, (c, s0, 0), (1, K, C))[0]
        if tape.indirect:
            idx = _resolve_cells(index_table, idx)
        dt = jax.lax.dynamic_slice(dt_t, (c, s0, 0), (1, K, C))[0]
        counts = jax.lax.dynamic_slice(counts_t, (c, 0), (1, C))[0]
        ds = jax.lax.dynamic_slice(ds_t, (c, 0), (1, C))[0]
        vd = jax.lax.dynamic_slice(vd_t, (c, 0, 0), (1, C, 3))[0]
        # base_basis is evaluated on the (C, 3) chunk slice — the SAME
        # shape/op sequence as the march's per-chunk evaluation, so the
        # basis values bit-match it (a batched all-chunks eval rounds a
        # few lanes differently). Re-evaluated per round: a little
        # elementwise work buys the bit-exact replay contract.
        base_basis = (
            eval_basis(opt.format, opt.basis_dim, vd, spec_v.extra_data)
            * window
            if opt.format != FORMAT_RGBA else None
        )
        valid = (s0 + slot_k)[:, None] < counts[None]
        if can_stop:
            valid = jnp.logical_and(valid, jnp.logical_not(stopped)[None])
        if want_weight_accum:
            node_flat = jax.lax.dynamic_slice(
                cell_t, (c, s0, 0), (1, K, C)
            )[0].reshape(-1)
        else:
            node_flat = None
        act_end = counts > (s0 + K)
        L, out_c, alpha, _, stopped, waccum = _phase2_radiometry(
            spec_v, features_t, opt, None, None, vd, base_basis,
            window, ds, n_color, K, dtype, can_stop,
            idx, dt, valid, None, None, node_flat,
            L, out_c, alpha, act_end, stopped, waccum,
            want_weight_accum=want_weight_accum,
            n_cells=tape.n_cells,
        )
        # Finalize the running state and (re)write chunk c's output rows
        # — the last round's write wins (identical math to the march's
        # finalize; no hit flag needed, see the module docstring).
        if can_stop:
            fin = jnp.where(
                stopped[:, None], out_c, out_c + (L * bg)[:, None]
            )
            alpha_f = jnp.where(stopped, alpha, 1.0 - L)
        else:
            fin = out_c + (L * bg)[:, None]
            alpha_f = 1.0 - L
        out_buf = jax.lax.dynamic_update_slice(
            out_buf,
            jnp.concatenate([fin, alpha_f[:, None]], axis=-1),
            (c * C, 0),
        )
        # advance within the chunk, or to the next chunk (resetting the
        # per-ray radiometry state)
        cap = jax.lax.dynamic_slice(caps_t, (c,), (1,))[0]
        done = (s0 + K) >= cap
        if can_stop:
            done = jnp.logical_or(
                done,
                jnp.logical_not(jnp.any(jnp.logical_and(
                    jnp.logical_not(stopped), counts > (s0 + K)
                ))),
            )
        c = c + done.astype(jnp.int32)
        s0 = jnp.where(done, 0, s0 + K)
        L = jnp.where(done, 1.0, L)
        out_c = jnp.where(done, 0.0, out_c)
        alpha = jnp.where(done, 0.0, alpha)
        stopped = jnp.logical_and(stopped, jnp.logical_not(done))
        return c, s0, L, out_c, alpha, stopped, out_buf, waccum

    per_ray = (C,) if can_stop else (1,)
    init = (
        jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.ones((C,), dtype),
        jnp.zeros((C, n_color), dtype),
        jnp.zeros(per_ray, dtype),
        jnp.zeros(per_ray, bool),
        jnp.broadcast_to(bg_row, (NC * C, n_color + 1)),
        waccum0,
    )
    *_, out_buf, waccum = jax.lax.while_loop(cond, body, init)
    out_flat = out_buf
    if nz:
        out_flat = jnp.concatenate(
            [jnp.broadcast_to(bg_row, (nz * C, n_color + 1)), out_flat]
        )
    return out_flat, (waccum if want_weight_accum else None)


def _replay_bwd_impl(tape: RayTape, features, opt: RenderOptions,
                     grad_out_sorted, out_sorted, spec=None,
                     index_table=None, emit_only=False, share_idx=False):
    """Gradient of the replay wrt the feature pool (dense (M, D)).

    Exact mode (sigma_thresh == 0, stop_thresh <= 0): single-pass tape
    replay — ray totals recovered from the saved outputs exactly as the
    march backward does (`_volume_render_bwd_impl`), gradient rows
    scattered with the shared tiered compact scatter. Thresholded modes
    fall back to the march backward over the tape's stored rays (same
    grads, structure re-march cost)."""
    Mloc, D = features.shape
    n_color = get_out_data_dim(opt.format, opt.basis_dim, D) - 1
    # The replay backward honors bwd_round_size like the march backward
    # does (apply_bwd_sizing) — but with the OPPOSITE default sweet spot:
    # with no structure walk in the round, a bigger backward round
    # amortizes the per-round scatter fixed costs (not yet measured on
    # the GPU, ROADMAP 1.7). Round grouping is semantics-free
    # (grads shift by regrouping ulps only). The round size is baked
    # into the tape's backward program (bwd_prog_K; default 8, set via
    # opt.bwd_round_size at RECORD time).
    K = max(1, tape.bwd_prog_K)
    C = tape.C
    spec_v = spec if spec is not None else _NOSPEC
    features_t = _pool_view(features, opt, spec)
    M = features_t.M
    dtype = tape.dt.dtype

    _check_indirect(tape, index_table)
    single_pass = opt.sigma_thresh == 0.0 and opt.stop_thresh <= 0.0
    if emit_only:
        assert single_pass and tape.n_chunks > tape.n_zero, (
            "emit_only is internal to the N-frame combined flush "
            "(exact mode, non-empty tapes only)"
        )
    if not single_pass:
        from .render import _volume_render_bwd_impl

        if tape.indirect:
            raise ValueError(
                "thresholded gradients are not supported on data-indirect "
                "tapes (the march-backward fallback needs a fixed spec); "
                "use exact mode (sigma_thresh=0, stop_thresh=0)"
            )
        if spec is None:
            raise ValueError(
                "thresholded tape gradients need `spec` (march-backward "
                "fallback)"
            )
        Bp = tape.n_chunks * C
        return _volume_render_bwd_impl(
            spec, features,
            tape.origins.reshape(Bp, 3), tape.dirs.reshape(Bp, 3),
            tape.vdirs.reshape(Bp, 3), grad_out_sorted, opt,
            out_res=out_sorted,
        )

    idx_t, dt_t, _, Sp = _pad_tape_to_round(tape, K)
    slot_k = jnp.arange(K, dtype=jnp.int32)

    def _to_local(sidx):
        return _scatter_to_local(sidx, features_t, Mloc, opt)

    # All-empty leading chunks contribute no gradient (no occupied
    # samples -> no contrib rows); skip them statically. Like the
    # forward, ONE flat while over global rounds replaces the
    # scan-of-whiles (whose per-step MB-sized xs copies dominated).
    nz = tape.n_zero
    NC = tape.n_chunks - nz
    g0 = jnp.zeros((Mloc, D), dtype)
    if opt.pool_axis is not None:
        # Row-sharded pools: the per-round scatter indices carry
        # axis_index, so the gradient varies over every manual axis the
        # local pool shard does. Lift the zero init's varying-manual-
        # axes up front — a scan carry must keep a stable type (pure
        # type cast, no numerics).
        from .render import _pvary_like

        g0 = _pvary_like(g0, features_t.table)
    if NC == 0:
        return g0
    idx_t = idx_t[nz:]
    dt_t = dt_t[nz:]
    counts_t = tape.counts[nz:]
    vd_t = tape.vdirs[nz:]
    ds_t = tape.dscale[nz:]
    gout_t = grad_out_sorted.reshape(tape.n_chunks, C, n_color + 1)[nz:]
    outres_t = out_sorted.reshape(tape.n_chunks, C, n_color + 1)[nz:]
    window = (
        jnp.asarray(_basis_window(opt))
        if opt.format != FORMAT_RGBA else None
    )

    def round_rows(L, acc, xs):
        c, s0 = xs
        first = s0 == 0
        L = jnp.where(first, 1.0, L)
        idx = jax.lax.dynamic_slice(idx_t, (c, s0, 0), (1, K, C))[0]
        if tape.indirect:
            idx = _resolve_cells(index_table, idx)
        dt = jax.lax.dynamic_slice(dt_t, (c, s0, 0), (1, K, C))[0]
        counts = jax.lax.dynamic_slice(counts_t, (c, 0), (1, C))[0]
        ds = jax.lax.dynamic_slice(ds_t, (c, 0), (1, C))[0]
        vd = jax.lax.dynamic_slice(vd_t, (c, 0, 0), (1, C, 3))[0]
        g_out = jax.lax.dynamic_slice(
            gout_t, (c, 0, 0), (1, C, n_color + 1))[0]
        out_res = jax.lax.dynamic_slice(
            outres_t, (c, 0, 0), (1, C, n_color + 1))[0]
        base_basis = (
            eval_basis(opt.format, opt.basis_dim, vd, spec_v.extra_data)
            * window
            if opt.format != FORMAT_RGBA else None
        )
        g_color = g_out[:, :n_color]
        g_alpha = g_out[:, n_color]
        L_ray = 1.0 - out_res[:, n_color]
        # chunk entry (s0 == 0): accum restarts at the ray total
        acc = jnp.where(
            first,
            jnp.sum(out_res[:, :n_color] * g_color, axis=-1),
            acc,
        )
        valid = (s0 + slot_k)[:, None] < counts[None]
        feat, sigma, _ = _round_sigma(
            spec_v, features_t, opt, None, None, None, None, idx, dtype
        )
        gi_flat = (jnp.where(idx < M, idx, 0) if M else idx).reshape(-1)
        contrib = jnp.logical_and(valid, sigma > 0.0)
        att = jnp.exp(-dt * ds[None] * sigma)
        att_eff = jnp.where(contrib, att, 1.0)
        cp = jnp.cumprod(att_eff, axis=0)
        L_before = L[None] * jnp.concatenate(
            [jnp.ones((1, C), dtype), cp[:-1]], axis=0
        )
        L_after = L[None] * cp
        weight = L_before * (1.0 - att)
        rows, total_color = _round_grad_rows(
            opt, spec_v, vd, gi_flat, feat, base_basis, window,
            weight, g_color, n_color, K,
        )
        wtc = jnp.where(contrib, weight * total_color, 0.0)
        acc_after = acc[None] - jnp.cumsum(wtc, axis=0)
        dts = dt * ds[None]
        g_sigma = dts * (total_color * L_after - acc_after) + (
            dts * (g_alpha * L_ray)[None]
        )
        rows_full = jnp.concatenate(
            [rows, g_sigma.reshape(-1)[:, None]], axis=-1
        )
        if share_idx:
            # Frame-invariant destinations (the N-frame combined flush,
            # `_replay_bwd_frames_impl`, shares ONE scatter across
            # frames): route every VALID in-pool sample to its true row
            # and zero the non-contributing rows instead — x + 0.0 adds
            # are identity, so the flushed sums match the contrib-routed
            # scatter. contrib ⊆ valid & (idx < M) (empty rows read
            # sigma 0), so no destination is lost.
            rows_full = jnp.where(
                contrib.reshape(-1)[:, None], rows_full, 0.0
            )
            sidx = jnp.where(
                jnp.logical_and(valid, idx < M).reshape(-1), gi_flat, M
            )
        else:
            sidx = jnp.where(contrib.reshape(-1), gi_flat, M)
        return (L * cp[-1], acc_after[-1]), _to_local(sidx), rows_full

    init = (jnp.ones((C,), dtype), jnp.zeros((C,), dtype))
    xs = (tape.bwd_round_chunk, tape.bwd_round_s0)

    # The bulk flush materializes the full gradient-row ys buffer
    # (rounds x K*C x (n_cc+1) f32 — ~180 MB on the headline scene);
    # V-view rig / training tapes scale it with V*W*H, so past a safety
    # cap fall back to the tiered per-round scatter automatically
    # (slower, O(pool) memory) instead of risking device OOM.
    n_cc = (
        n_color * opt.basis_dim if opt.format != FORMAT_RGBA else n_color
    )
    ys_bytes = int(xs[0].shape[0]) * K * C * (n_cc + 1) * 4
    if emit_only:
        # N-frame combined flush (`_replay_bwd_frames_impl`): emit this
        # frame's gradient rows only — destinations are frame-invariant
        # (share_idx) and scattered ONCE by the caller.
        def body(carry, xs_):
            (L, acc), _sloc, rows = round_rows(carry[0], carry[1], xs_)
            return (L, acc), rows

        _, rows_all = jax.lax.scan(body, init, xs)
        return rows_all

    if opt.bwd_bulk_scatter and ys_bytes <= _BULK_YS_MAX_BYTES:
        # Flat-program bulk flush: grad rows leave the scan as ys
        # (written once, never carried — no scan-carry copies), then ONE
        # bulk scatter-add lands them.
        # Dummy rows carry index Mloc (out of bounds) and drop.
        def body(carry, xs_):
            (L, acc), sloc, rows = round_rows(carry[0], carry[1], xs_)
            return (L, acc), (sloc, rows)

        _, (sloc_all, rows_all) = jax.lax.scan(body, init, xs)
        return g0.at[sloc_all.reshape(-1)].add(
            rows_all.reshape(-1, rows_all.shape[-1]), mode="drop"
        )

    def body(carry, xs_):
        (L, acc), sloc, rows = round_rows(carry[0], carry[1], xs_)
        grad = _scatter_add_compact(carry[2], sloc, rows, Mloc)
        return (L, acc, grad), None

    (_, _, grad), _ = jax.lax.scan(body, init + (g0,), xs)
    return grad


def _bwd_shared_sloc(tape: RayTape, Mloc: int, index_table=None):
    """Frame-invariant flush destinations for the combined N-frame
    backward: the exact sidx stream `round_rows(share_idx=True)` routes
    to, computed WITHOUT features (a cheap integer scan over the tape's
    backward round program). Returns (rounds, K*C) int32 in [0, Mloc];
    Mloc is the drop slot."""
    K = max(1, tape.bwd_prog_K)
    C = tape.C
    idx_t, _, _, _ = _pad_tape_to_round(tape, K)
    nz = tape.n_zero
    idx_t = idx_t[nz:]
    counts_t = tape.counts[nz:]
    slot_k = jnp.arange(K, dtype=jnp.int32)

    def one(carry, xs_):
        c, s0 = xs_
        idx = jax.lax.dynamic_slice(idx_t, (c, s0, 0), (1, K, C))[0]
        if tape.indirect:
            idx = _resolve_cells(index_table, idx)
        counts = jax.lax.dynamic_slice(counts_t, (c, 0), (1, C))[0]
        valid = (s0 + slot_k)[:, None] < counts[None]
        vf = idx < Mloc
        sidx = jnp.where(
            jnp.logical_and(valid, vf), jnp.where(vf, idx, 0), Mloc
        )
        return carry, sidx.reshape(-1)

    _, sloc = jax.lax.scan(
        one, 0, (tape.bwd_round_chunk, tape.bwd_round_s0)
    )
    return sloc


# Combined N-frame flush cap: the (rounds*K*C, N, D) ys stack plus its
# transposed copy live simultaneously (~2x) — past this, fall back to
# per-frame backwards rather than risk device OOM. Not yet re-sized for
# the GPU's memory (ROADMAP 1.7).
_WIDE_YS_MAX_BYTES = 7 << 30


def _replay_bwd_frames_impl(tape: RayTape, features_frames, opt,
                            grad_outs, outs, spec=None, index_table=None):
    """Gradients of N independent replays with ONE combined wide flush.

    The bulk flush was built as row-count-bound, not byte-bound, and
    its destinations are frame-invariant once the
    sigma>0 routing moves from the index side to the row side
    (share_idx). So N frames' gradient rows land in ONE
    (T, N, D) -> (M, N, D) scatter-add and the single-frame flush cost
    amortizes to ~1/N per frame.

    ys emission stays an OUTER scan over frames so each frame's inner
    round scan keeps its own (M, D) table as a loop invariant.

    Falls back to a per-frame scan of the single-frame backward
    (identical gradients, N flushes) for thresholded modes, sharded
    pools, bulk-flush opt-outs, or oversized ys stacks."""
    N, Mloc, D = features_frames.shape
    dtype = tape.dt.dtype
    single_pass = opt.sigma_thresh == 0.0 and opt.stop_thresh <= 0.0
    K = max(1, tape.bwd_prog_K)
    C = tape.C
    R = int(tape.bwd_round_chunk.shape[0])
    wide_bytes = N * R * K * C * D * 4
    if tape.n_chunks <= tape.n_zero:
        return jnp.zeros((N, Mloc, D), dtype)
    if (not single_pass or opt.pool_axis is not None
            or not opt.bwd_bulk_scatter
            or wide_bytes > _WIDE_YS_MAX_BYTES):
        def one(carry, xs_):
            f, go, o = xs_
            g = _replay_bwd_impl(tape, f, opt, go, o, spec,
                                 index_table=index_table)
            return carry, g

        _, gs = jax.lax.scan(
            one, 0, (features_frames, grad_outs, outs)
        )
        return gs

    def emit(carry, xs_):
        f, go, o = xs_
        rows = _replay_bwd_impl(tape, f, opt, go, o, spec,
                                index_table=index_table,
                                emit_only=True, share_idx=True)
        return carry, rows

    _, rows_n = jax.lax.scan(emit, 0, (features_frames, grad_outs, outs))
    # (N, rounds, K*C, D) -> FLAT (T, N*D): one bandwidth-rate transpose
    # so the flush reads each destination's N frame-blocks contiguously.
    # The layout stays flat 2-D (T, N*D).
    T_rows = R * K * C
    rows_t = rows_n.reshape(N, T_rows, D).transpose(1, 0, 2).reshape(
        T_rows, N * D
    )
    sloc = _bwd_shared_sloc(tape, Mloc, index_table).reshape(-1)
    g = jnp.zeros((Mloc, N * D), dtype).at[sloc].add(rows_t, mode="drop")
    return g.reshape(Mloc, N, D).transpose(1, 0, 2)


def unsort_output(tape: RayTape, out_sorted):
    """Map replay output rows from the tape's sorted+padded layout back
    to the original ray order. Group-sorted tapes (`tape.group` > 1)
    gather n_rays/group contiguous blocks — ~10x cheaper than the
    ray-level row gather on image-sized batches. Tapes recorded in
    2-D pixel-block order (`tape.out_blocks`) additionally transpose
    block-major back to raster order (pure reshape/transpose).

    CAVEAT (grouped tapes): the block gather reconstructs the RECORDED
    INPUT order (modulo `out_blocks`) and bypasses `inv_pos` — a
    composed/edited `inv_pos` on a `group > 1` tape is silently ignored
    here; record grouped tapes in the order you want outputs back in
    (the renderer's recorders do), or use `inv_pos` yourself with
    `unsort=False` outputs."""
    w = out_sorted.shape[-1]
    if tape.group > 1:
        blocks = out_sorted.reshape(-1, tape.group, w)
        out = blocks[tape.ginv].reshape(tape.n_rays, w)
        if tape.out_blocks:
            nbh, nbw, bh, bw = tape.out_blocks
            out = (
                out.reshape(-1, nbh, nbw, bh, bw, w)
                .swapaxes(2, 3)
                .reshape(tape.n_rays, w)
            )
        return out
    return out_sorted[tape.inv_pos]


@functools.partial(jax.jit, static_argnames=("opt",))
def _replay_depth_impl(tape: RayTape, features, index_table,
                       opt: RenderOptions):
    K = 8
    C = tape.C
    dtype = tape.dt.dtype
    M = tape.n_features
    if M == 0 or features.shape[0] == 0:
        return jnp.zeros((tape.n_chunks * C, 1), dtype)
    sig_col = features[:, -1].astype(dtype)
    Mrows = features.shape[0]
    # Pad the sample axis to a multiple of K (pad slots sit past every
    # count and are masked; indirect pads use cell 0 to keep the
    # resolve gather in range — same rule as _pad_tape_to_round).
    S = tape.idx.shape[1]
    Sp = -(-S // K) * K
    fill = 0 if tape.indirect else int(DATA_SENTINEL)
    padw = ((0, 0), (0, Sp - S), (0, 0))
    idx_t = jnp.pad(tape.idx, padw, constant_values=fill)
    tv_t = jnp.pad(tape.tval, padw)
    # Leading all-empty chunks have zero resident samples — depth 0.
    nz = tape.n_zero
    idx_t, tv_t = idx_t[nz:], tv_t[nz:]
    counts_t, ds_t = tape.counts[nz:], tape.dscale[nz:]

    def chunk(_, xs):
        idx_c, tv_c, counts, ds = xs

        def cond(carry):
            s0, found = carry[0], carry[1]
            return jnp.logical_and(
                s0 < Sp, jnp.logical_not(jnp.all(found))
            )

        def body(carry):
            s0, found, t_hit = carry
            idx = jax.lax.dynamic_slice(idx_c, (s0, 0), (K, C))
            if tape.indirect:
                idx = _resolve_cells(index_table, idx)
            tv = jax.lax.dynamic_slice(tv_c, (s0, 0), (K, C))
            k_abs = s0 + jnp.arange(K, dtype=jnp.int32)
            valid = k_abs[:, None] < counts[None, :]
            resident = jnp.logical_and(valid, idx < M)
            safe = jnp.where(resident, idx, 0)
            over = jnp.logical_and(
                resident, sig_col[safe] > opt.sigma_thresh
            )
            first = jnp.logical_and(
                over, (jnp.cumsum(over, axis=0) - over) == 0
            )
            any_f = jnp.any(first, axis=0)
            t_sel = jnp.sum(jnp.where(first, tv, 0.0), axis=0)
            newly = jnp.logical_and(any_f, jnp.logical_not(found))
            t_hit = jnp.where(newly, t_sel, t_hit)
            found = jnp.logical_or(found, any_f)
            return s0 + K, found, t_hit

        init = (jnp.zeros((), jnp.int32), jnp.zeros((C,), bool),
                jnp.zeros((C,), dtype))
        _, found, t_hit = jax.lax.while_loop(cond, body, init)
        return 0, jnp.where(found, t_hit * ds, 0.0)

    _, depth_nz = jax.lax.scan(chunk, 0, (idx_t, tv_t, counts_t, ds_t))
    depth = (
        jnp.concatenate([jnp.zeros((nz, C), dtype), depth_nz])
        if nz else depth_nz
    )
    return depth.reshape(-1, 1)


def replay_depth(tape: RayTape, features, opt: RenderOptions, spec=None,
                 *, unsort: bool = True, index_table=None):
    """First-hit depth by tape replay: per ray, the march parameter t
    of the first sample whose sigma exceeds ``opt.sigma_thresh`` in a
    RESIDENT leaf, scaled by delta_scale — `render_depth` semantics
    (rt_kernel.cu:781-834 via ops/render_aux._first_hit), equal to the
    march pass for ``sigma_thresh >= 0`` (where empty-leaf sigma is
    masked to 0, so the over-threshold and resident notions coincide;
    the pathological thresh < 0 case diverges exactly as _first_hit
    documents). Requires a tape recorded with ``record_t=True``.
    Data-indirect tapes resolve residency through ``index_table``, so
    depth follows each FRAME's occupancy under animation. Not
    differentiable (first-hit selection); nearest mode only.

    Returns (B, 1) in original ray order when ``unsort``, else
    (n_chunks*C, 1) in tape order."""
    if tape.tval is None:
        raise ValueError(
            "tape has no per-sample t — record with record_t=True for "
            "depth replay"
        )
    if opt.interp:
        raise ValueError("tapes do not support opt.interp")
    if isinstance(features, QuantizedFeatures):
        raise NotImplementedError(
            "replay_depth: pass the float pool (quantized pools are an "
            "inference color path)"
        )
    if opt.pool_axis is not None:
        raise NotImplementedError(
            "replay_depth: sharded pools not supported"
        )
    _check_indirect(tape, index_table)
    _check_geom(tape, spec, opt)
    features = jnp.asarray(features)
    if features.shape[0] != tape.n_features:
        raise ValueError(
            f"feature pool has {features.shape[0]} rows but the tape "
            f"was recorded against {tape.n_features} — the structure "
            "changed; re-record the tape"
        )
    out = _replay_depth_impl(tape, features, index_table, opt)
    if unsort:
        return unsort_output(tape, out)
    return out


def replay_render(tape: RayTape, features, opt: RenderOptions, spec=None,
                  *, unsort: bool = True, index_table=None):
    """Render by replaying a recorded tape — differentiable wrt
    ``features`` via the hand-written VJP (exact mode single-pass;
    thresholded modes fall back to the march backward).

    ``index_table`` (data-indirect tapes only): the frame's packed index
    table from :func:`pack_index_table` — gradients still flow to
    ``features`` (the table is integer routing, zero cotangent).

    Returns (B, n_color+1) in the ORIGINAL ray order when ``unsort``
    (one output gather), else (n_chunks*C, n_color+1) in tape order
    (the first rows of the padded layout are duplicates — use
    ``tape.inv_pos`` to map ray i to its row)."""
    out_sorted = _replay_call(tape, features, index_table, opt, spec)
    if unsort:
        return unsort_output(tape, out_sorted)
    return out_sorted


def replay_render_weighted(tape: RayTape, features, opt: RenderOptions,
                           spec=None, *, unsort: bool = True,
                           index_table=None):
    """Replay + weight accumulation (mirrors
    `volume_render_with_weight_accum`: differentiable wrt ``features``
    through the color output; the weight output carries no gradient).
    Returns (out, waccum)."""
    out_sorted, waccum = _replay_call_w(tape, features, index_table, opt,
                                        spec)
    if unsort:
        out_sorted = unsort_output(tape, out_sorted)
    return out_sorted, waccum


def replay_render_frames(tape: RayTape, features_frames,
                         opt: RenderOptions, spec=None, *,
                         unsort: bool = True, index_table=None):
    """Replay one recorded tape over a STACK of feature frames in one
    differentiable program. Forward scans frames (each replay identical
    to :func:`replay_render`); backward evaluates all N per-frame
    gradients with ONE combined wide flush (`_replay_bwd_frames_impl`)
    instead of N single-frame flushes — the flush is the single-frame
    backward's floor, so gradient-evaluation throughput over a feature
    stream scales ~N x until ys memory caps it.

    The N gradients are independent per-frame cotangents (frames share
    the tape's geometry, not values) — the entry point for gradient
    evaluation over a feature stream: multi-frame fitting, gradient
    accumulation across time steps of a dynamic sequence (one shared
    ``index_table``), or scoring a generator's feature stack. A
    sequential SGD chain (step n+1's forward needs step n's update)
    cannot share the flush — keep :func:`replay_render` there.

    ``features_frames``: (N, M, D). Returns (N, B, n_color+1)."""
    out = _replay_call_frames(tape, features_frames, index_table, opt,
                              spec)
    if unsort:
        return jax.vmap(lambda o: unsort_output(tape, o))(out)
    return out


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _replay_call_frames(tape, features_frames, index_table, opt, spec):
    def one(carry, f):
        o, _ = _replay_fwd_impl(tape, f, opt, spec,
                                index_table=index_table)
        return carry, o

    _, outs = jax.lax.scan(one, 0, features_frames)
    return outs


def _replay_call_frames_fwd(tape, features_frames, index_table, opt,
                            spec):
    outs = _replay_call_frames(tape, features_frames, index_table, opt,
                               spec)
    return outs, (tape, features_frames, index_table, spec, outs)


def _replay_call_frames_bwd(opt, res, g):
    from .render import QuantizedFeatures, _zero_cotangent

    tape, features_frames, index_table, spec, outs = res
    if isinstance(features_frames, QuantizedFeatures):
        gf = _zero_cotangent(features_frames)
    else:
        gf = _replay_bwd_frames_impl(tape, features_frames, opt, g, outs,
                                     spec, index_table=index_table)
    return (_zero_cotangent(tape), gf, _zero_cotangent(index_table),
            _zero_cotangent(spec))


_replay_call_frames.defvjp(_replay_call_frames_fwd,
                           _replay_call_frames_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _replay_call(tape, features, index_table, opt, spec):
    out, _ = _replay_fwd_impl(tape, features, opt, spec,
                              index_table=index_table)
    return out


def _replay_call_fwd(tape, features, index_table, opt, spec):
    out, _ = _replay_fwd_impl(tape, features, opt, spec,
                              index_table=index_table)
    return out, (tape, features, index_table, spec, out)


def _replay_call_bwd(opt, res, g):
    from .render import QuantizedFeatures, _zero_cotangent

    tape, features, index_table, spec, out = res
    if isinstance(features, QuantizedFeatures):
        gf = _zero_cotangent(features)
    else:
        gf = _replay_bwd_impl(tape, features, opt, g, out, spec,
                              index_table=index_table)
    return (_zero_cotangent(tape), gf, _zero_cotangent(index_table),
            _zero_cotangent(spec))


_replay_call.defvjp(_replay_call_fwd, _replay_call_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _replay_call_w(tape, features, index_table, opt, spec):
    return _replay_fwd_impl(tape, features, opt, spec,
                            want_weight_accum=True,
                            index_table=index_table)


def _replay_call_w_fwd(tape, features, index_table, opt, spec):
    out, waccum = _replay_fwd_impl(tape, features, opt, spec,
                                   want_weight_accum=True,
                                   index_table=index_table)
    return (out, waccum), (tape, features, index_table, spec, out)


def _replay_call_w_bwd(opt, res, g):
    from .render import QuantizedFeatures, _zero_cotangent

    tape, features, index_table, spec, out = res
    g_out, _ = g  # the weight output carries no gradient (reference
    # parity: weights accumulate in the forward kernel only)
    if isinstance(features, QuantizedFeatures):
        gf = _zero_cotangent(features)
    else:
        gf = _replay_bwd_impl(tape, features, opt, g_out, out, spec,
                              index_table=index_table)
    return (_zero_cotangent(tape), gf, _zero_cotangent(index_table),
            _zero_cotangent(spec))


_replay_call_w.defvjp(_replay_call_w_fwd, _replay_call_w_bwd)
