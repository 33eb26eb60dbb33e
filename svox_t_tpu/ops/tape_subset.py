"""Row-subset tape replay — random-pixel minibatch training at tape rates.

The canonical NeRF/Artemis training loop samples random pixels across a
FIXED set of training cameras every step (reference
svox_t/renderer.py:207-308 takes arbitrary ray batches; the CUDA SIMT
march doesn't care which rays arrive, rt_kernel.cu:654-671). That access
pattern is exactly the tape amortization class — the camera set is fixed,
only the ROW SUBSET varies — but a recorded :class:`~.tape.RayTape` is a
whole-batch artifact: its chunking, count sort, and flat round programs
are baked for all recorded rays.

This module makes tapes serve row subsets:

  * :class:`TapeRowSource` — a one-time RAY-MAJOR re-layout of a recorded
    tape into ONE packed int32 matrix (idx | dt bits | [t bits] | vdir
    bits | dscale bits | count per row), so pulling an arbitrary ray set
    is a SINGLE row gather instead of one per field (the source is
    hundreds of MB, so every subset gather is a random read from
    device memory).
  * :func:`subset_tape` — build a standalone :class:`RayTape` for a host
    array of ray ids: host-side radix sort by sample count (the parent's
    ordering invariant), device row gather + re-chunk, fresh flat round
    programs. The result works with EVERY existing replay entry point
    (`replay_render`, `replay_render_frames` + wide flush,
    `replay_depth`, weight accumulation) unchanged.
  * :func:`replay_render_rows` — subset + replay in one call.
  * :func:`train_minibatches` — the training fast path: N sequential SGD
    steps (step n+1 sees step n's update) over N random minibatches in
    ONE dispatch; per step the subset gather runs in-graph from the
    packed source, so the host ships only the (N, Bp) row-position
    array. The gather touches ONLY the non-zero-occupancy suffix of each
    batch (a minority of rays on the shell scenes — the zero prefix replays
    to the background constant without reading any tape data). All N
    steps share one conservative round program (the union of the
    batches' per-chunk caps — extra rounds are provable no-ops), so
    executables are reused across calls.
  * :func:`train_steps` — the fixed-ray (full-tape) SGD chain, one
    dispatch.

Semantics: a subset replay of rays R equals the full replay restricted
to R. Per-ray round grouping is PRESERVED (each ray's recorded slot
stream replays from s0=0 at the tape's own prog_K regardless of which
chunk it lands in), so compact=False subsets are bitwise equal to the
full replay's rows — except that a basis-format (SH/SG/ASG) replay
whose subset CHUNK SHAPE differs from the parent's can shift eval_basis
by 1 ulp on a few lanes (the cross-program batch-shape sensitivity
documented in CLAUDE.md; RGBA is shape-free and exactly bitwise).
Gradients flow through the standard tape VJP; a subset gradient equals
the full-batch gradient of a loss masked to R (tested).

Cost structure: a step is the source gather + the backward rounds +
the gradient flush over the ALLOCATED rows — all three per-step serial
(the SGD chain's flush feeds the next step's forward, so flushes can
never batch across steps the way `replay_render_frames` batches
independent per-frame gradients). Not yet measured on the GPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.spec import RenderOptions
from .tape import RayTape, _replay_call, _round_program, _size_bucket


def _bits(a):
    return jax.lax.bitcast_convert_type(a, jnp.int32)


def _floats(a):
    return jax.lax.bitcast_convert_type(a, jnp.float32)


@jax.jit
def _pack_source(idx_rm, dt_rm, tval_rm, vdirs_rm, dscale_rm, counts_rm):
    cols = [idx_rm, _bits(dt_rm)]
    if tval_rm is not None:
        cols.append(_bits(tval_rm))
    cols += [_bits(vdirs_rm), _bits(dscale_rm[:, None]),
             counts_rm[:, None]]
    return jnp.concatenate(cols, axis=1)


class TapeRowSource:
    """Ray-major packed view of a recorded tape, built once per tape for
    row-subset extraction.

    Device arrays (``n_rows = n_chunks * C`` padded-layout rows):
      packed:  (n_rows, 2S [+S] + 5) int32 — per ray: sample index
               stream (S), dt bits (S), [t bits (S) when the parent was
               recorded with record_t], viewdir bits (3), dscale bits
               (1), count (1). ONE gather pulls everything a replay
               needs.
      cell_rm: (n_rows, S) int32 or None — tree-cell stream (weight
               accumulation), kept only when ``keep_cells``.
      origins_rm / dirs_rm: (n_rows, 3) f32 — kept for the thresholded
               backward's march fallback (small; gathered only by
               :func:`subset_tape`, never in the training hot loop).

    Host metadata: the parent's padded-layout counts and the ray-id ->
    padded-row map (``inv_host``), used to order and chunk subsets
    without any device round trip.
    """

    def __init__(self, tape: RayTape, *, keep_cells: bool = False):
        if tape.n_chunks == 0:
            raise ValueError("empty tape")
        C, S = tape.C, tape.S
        n_rows = tape.n_chunks * C

        def rm(a):
            return a.swapaxes(1, 2).reshape(n_rows, S)

        self.has_t = tape.tval is not None
        self.packed = _pack_source(
            rm(tape.idx), rm(tape.dt),
            rm(tape.tval) if self.has_t else None,
            tape.vdirs.reshape(n_rows, 3),
            tape.dscale.reshape(n_rows),
            tape.counts.reshape(n_rows),
        )
        self.cell_rm = (
            rm(tape.cell) if (keep_cells and tape.cell is not None)
            else None
        )
        self.origins_rm = tape.origins.reshape(n_rows, 3)
        self.dirs_rm = tape.dirs.reshape(n_rows, 3)

        # Host copies for ordering (fetched once; ~n_rays ints). The
        # per-batch prep cost is host-gather-bound, so everything it
        # touches is int32 and the ray-id -> count map is precomposed.
        self.counts_host = np.asarray(
            jax.device_get(tape.counts)
        ).reshape(n_rows).astype(np.int32)
        self.inv_host = np.asarray(
            jax.device_get(tape.inv_pos)
        ).astype(np.int32)
        self.counts_by_id = self.counts_host[self.inv_host]
        # Parent zero-occupancy prefix (padded rows below this index are
        # rays with zero OCCUPIED samples — the only zero-occupancy
        # signal available for uncompacted parents, whose counts column
        # holds TOTAL samples).
        self._zero_rows = tape.n_zero * C

        self.n_rays = tape.n_rays
        self.S = S
        self.compact = tape.compact
        self.indirect = tape.indirect
        self.n_features = tape.n_features
        self.n_cells = tape.n_cells
        self.geom = tape.geom
        self.prog_K = tape.prog_K
        self.bwd_prog_K = tape.bwd_prog_K
        self.dtype = tape.dt.dtype

    def _occ_flags(self, pos, counts):
        """Zero-occupancy flag per subset ray (False = provably zero)."""
        if self.compact:
            return counts > 0
        return pos >= self._zero_rows

    def prep(self, ids, chunk_size: int = 512, r_quant: int = 8):
        """Host-side subset layout: sort by sample count (parent
        invariant: zero-occupancy first, then ascending), pad to a chunk
        multiple, derive caps / tape width / zero prefix / round
        programs. Pure NumPy (radix argsort on the int count key) — no
        device sync. Returns a :class:`_SubsetPlan`."""
        ids = np.asarray(ids).reshape(-1)
        B = ids.shape[0]
        if B == 0:
            raise ValueError("empty ray-id set")
        if ids.min() < 0 or ids.max() >= self.n_rays:
            raise ValueError(
                f"ray ids must be in [0, {self.n_rays}); got "
                f"[{ids.min()}, {ids.max()}]"
            )
        pos = self.inv_host[ids]
        counts = self.counts_by_id[ids]
        occ = self._occ_flags(pos, counts)
        if self.compact:
            # occ == (counts > 0), so ONE stable small-int argsort
            # (radix) gives zero-occupancy-first count order, cheaper
            # than a (counts, occ) lexsort.
            key = counts + (counts > 0)
            key = key.astype(np.uint8 if self.S < 255 else np.uint16)
            order = np.argsort(key, kind="stable")
        else:
            # Uncompacted parents: zero-occ rays carry TOTAL counts —
            # keep the two-key sort so the prefix stays
            # count-homogeneous.
            order = np.lexsort((counts, occ))
        pos_s = pos[order]
        counts_s = counts[order]

        C = max(1, min(int(chunk_size), B))
        Bp = -(-B // C) * C
        pad = Bp - B
        # Pad rows duplicate the cheapest subset ray (front of the sort)
        # — masked out of losses by callers via `pad`.
        pos_p = np.concatenate([pos_s[:1].repeat(pad), pos_s])
        ids_p = np.concatenate([ids[order][:1].repeat(pad), ids[order]])
        cnt_p = np.concatenate([counts_s[:1].repeat(pad), counts_s])
        occ_p = np.concatenate([occ[order][:1].repeat(pad), occ[order]])

        n_chunks = Bp // C
        n_zero = int(np.argmax(occ_p)) // C if occ_p.any() else n_chunks
        caps = cnt_p.reshape(n_chunks, C).max(axis=1)
        K_hi = max(self.prog_K, self.bwd_prog_K)
        cap = int(caps.max()) if n_chunks else 0
        S_sub = min(self.S, int(max(K_hi, _size_bucket(max(cap, 1)))))
        caps_nz = np.minimum(caps[n_zero:], S_sub)

        # original-subset-position i -> padded-layout row
        inv = np.empty(B, np.int64)
        inv[order] = np.arange(pad, Bp)
        return _SubsetPlan(
            pos_p=pos_p.astype(np.int64), ids_p=ids_p.astype(np.int64),
            caps_nz=caps_nz.astype(np.int64), inv=inv.astype(np.int32),
            B=B, C=C, pad=pad, n_chunks=n_chunks, n_zero=n_zero,
            S=S_sub, r_quant=int(r_quant),
        )


@dataclasses.dataclass(frozen=True)
class _SubsetPlan:
    """Host-side layout of one subset (see TapeRowSource.prep)."""

    pos_p: np.ndarray     # (Bp,) padded-layout source row per slot
    ids_p: np.ndarray     # (Bp,) original ray id per slot (targets)
    caps_nz: np.ndarray   # (n_chunks - n_zero,) per-chunk sample caps
    inv: np.ndarray       # (B,) subset position -> padded row
    B: int
    C: int
    pad: int
    n_chunks: int
    n_zero: int
    S: int
    r_quant: int


@dataclasses.dataclass(frozen=True)
class _SrcMeta:
    """Hashable static metadata of a TapeRowSource (trace constants)."""

    S: int
    has_t: bool
    compact: bool
    indirect: bool
    n_features: int
    n_cells: int
    geom: tuple
    prog_K: int
    bwd_prog_K: int

    @classmethod
    def of(cls, src: TapeRowSource):
        return cls(S=src.S, has_t=src.has_t, compact=src.compact,
                   indirect=src.indirect, n_features=src.n_features,
                   n_cells=src.n_cells, geom=src.geom,
                   prog_K=src.prog_K, bwd_prog_K=src.bwd_prog_K)


def _programs(caps_nz, prog_K: int, bwd_K: int, S: int, r_quant: int):
    rc, rs, lr = _round_program(caps_nz, prog_K, S, r_mult=r_quant)
    brc, brs, _ = _round_program(caps_nz, bwd_K, S, r_mult=r_quant)
    return rc, rs, lr, brc, brs


def _gather_subset(packed, meta: _SrcMeta, pos_nz, S: int, C: int,
                   n_chunks: int, n_zero: int, want_t: bool):
    """Gather + unpack + re-chunk the NON-ZERO suffix of a subset from
    the packed source, prepending all-zero prefix chunks (their rays
    have zero occupied samples: the replay never reads their tape slots
    and emits the background row — verified bitwise). Traceable — the
    minibatch trainer runs it per scan step.

    Returns (idx, dt, tval|None, counts, vdirs, dscale) in the chunked
    (n_chunks, S, C) / (n_chunks, C, ...) tape layout."""
    Sp = meta.S
    NC = n_chunks - n_zero
    g = jnp.take(packed, pos_nz, axis=0)  # (NCp*C, 2S[+S]+5)

    def zfront(a):
        pre = jnp.zeros((n_zero,) + a.shape[1:], a.dtype)
        return jnp.concatenate([pre, a]) if n_zero else a

    def grid(block):
        return block.reshape(NC, C, S).swapaxes(1, 2)

    idx = grid(g[:, :S])
    # Indirect tapes: the zero prefix must hold IN-RANGE cell ids (0),
    # which jnp.zeros provides; direct tapes' prefix reads as empty
    # only if >= n_features — but the replay slices the prefix off
    # before any use, so 0 is fine there too.
    dt = grid(_floats(g[:, Sp:Sp + S]))
    off = 2 * Sp
    tval = None
    if meta.has_t:
        if want_t:
            tval = grid(_floats(g[:, off:off + S]))
        off += Sp
    vd = _floats(g[:, off:off + 3]).reshape(NC, C, 3)
    ds = _floats(g[:, off + 3:off + 4]).reshape(NC, C)
    counts = jnp.minimum(g[:, off + 4], S).reshape(NC, C)
    return (zfront(idx), zfront(dt),
            zfront(tval) if tval is not None else None,
            zfront(counts), zfront(vd), zfront(ds))


def _build_tape(meta: _SrcMeta, plan: _SubsetPlan, arrays, programs,
                inv_pos, origins, dirs, cell=None) -> RayTape:
    idx, dt, tval, counts, vdirs, dscale = arrays
    rc, rs, lr, brc, brs = programs
    return RayTape(
        idx=idx, dt=dt, cell=cell, counts=counts,
        origins=origins, dirs=dirs, vdirs=vdirs, dscale=dscale,
        inv_pos=inv_pos,
        round_chunk=rc, round_s0=rs, last_round=lr,
        bwd_round_chunk=brc, bwd_round_s0=brs,
        n_rays=plan.B, C=plan.C, S=plan.S, compact=meta.compact,
        n_features=meta.n_features, n_cells=meta.n_cells,
        geom=meta.geom, n_zero=plan.n_zero, prog_K=meta.prog_K,
        bwd_prog_K=meta.bwd_prog_K, ginv=None, group=1, tval=tval,
        out_blocks=(), indirect=meta.indirect,
    )


@functools.partial(
    jax.jit,
    static_argnames=("meta", "S", "C", "n_chunks", "n_zero", "want_t"),
)
def _gather_subset_jit(packed, pos_nz, meta, S, C, n_chunks, n_zero,
                       want_t):
    return _gather_subset(packed, meta, pos_nz, S, C, n_chunks, n_zero,
                          want_t)


def subset_tape(source, ids, *, chunk_size: int = 512,
                r_quant: int = 8, with_rays: bool = True,
                prog_K: int = 0, bwd_prog_K: int = 0) -> RayTape:
    """Standalone :class:`RayTape` over an arbitrary subset of a
    recorded tape's rays.

    ``source`` is a :class:`TapeRowSource` (or a RayTape, converted on
    the fly — build the source once when subsetting repeatedly). ``ids``
    is a host int array of ORIGINAL ray indices (duplicates allowed —
    sampling with replacement replays the row twice). The subset tape
    replays/backprops through every existing tape entry point; outputs
    unsort to ``ids`` order.

    ``r_quant`` pads the round-program length to a multiple (executable
    reuse across same-size random batches — the round count is the one
    static that varies between equally-sized subsets). ``with_rays``
    gathers the subset's origins/dirs too (needed ONLY by the
    thresholded-mode backward's march fallback; the exact single-pass
    VJP never reads them)."""
    if isinstance(source, RayTape):
        source = TapeRowSource(source)
    plan = source.prep(ids, chunk_size=chunk_size, r_quant=r_quant)
    meta = _SrcMeta.of(source)
    if prog_K or bwd_prog_K:
        # Subset round-size overrides: compact tapes carry the regroup
        # license, so any K replays to the same values (~1e-7); for
        # compact=False parents the parent prog_K preserves bitwise
        # round grouping — keep the default there.
        meta = dataclasses.replace(
            meta,
            prog_K=int(prog_K) or meta.prog_K,
            bwd_prog_K=int(bwd_prog_K) or meta.bwd_prog_K,
        )
    programs = _programs(plan.caps_nz, meta.prog_K, meta.bwd_prog_K,
                         plan.S, plan.r_quant)
    pos_nz = jnp.asarray(
        plan.pos_p[plan.n_zero * plan.C:].astype(np.int32)
    )
    arrays = _gather_subset_jit(
        source.packed, pos_nz, meta, S=plan.S, C=plan.C,
        n_chunks=plan.n_chunks, n_zero=plan.n_zero, want_t=source.has_t,
    )
    if with_rays:
        pos_p = jnp.asarray(plan.pos_p.astype(np.int32))
        o = jnp.take(source.origins_rm, pos_p, axis=0).reshape(
            plan.n_chunks, plan.C, 3)
        d = jnp.take(source.dirs_rm, pos_p, axis=0).reshape(
            plan.n_chunks, plan.C, 3)
    else:
        o = jnp.zeros((plan.n_chunks, plan.C, 3), source.dtype)
        d = o
    cell = None
    if source.cell_rm is not None:
        # Weight-accumulating subsets (TapeRowSource(keep_cells=True)):
        # the tree-cell stream rides along like the ray constants —
        # zero-prefix chunks accumulate nothing (cell 0, never read).
        pos_p = jnp.asarray(plan.pos_p.astype(np.int32))
        cell = jnp.take(
            source.cell_rm[:, :plan.S], pos_p, axis=0
        ).reshape(plan.n_chunks, plan.C, plan.S).swapaxes(1, 2)
    return _build_tape(meta, plan, arrays, programs,
                       jnp.asarray(plan.inv), o, d, cell=cell)


def replay_render_rows(source, ids, features, opt: RenderOptions,
                       spec=None, *, unsort: bool = True,
                       index_table=None, chunk_size: int = 512):
    """Replay only the rays in ``ids``: :func:`subset_tape` +
    :func:`~.tape.replay_render`. Differentiable wrt ``features``; the
    gradient equals the full replay's gradient of a loss restricted to
    these rays (tested). Returns (len(ids), n_color+1) in ``ids`` order
    when ``unsort``."""
    from .tape import replay_render

    tape = subset_tape(source, ids, chunk_size=chunk_size)
    return replay_render(tape, features, opt, spec, unsort=unsort,
                         index_table=index_table)


@functools.lru_cache(maxsize=None)
def _sgd(lr: float):
    """Per-lr cached SGD update (the update fn is a STATIC argument of
    the jitted trainer — a fresh closure per call would recompile)."""
    def update(features, grad, state):
        return features - lr * grad, state
    return update


def _check_exact(opt: RenderOptions, who: str):
    if opt.sigma_thresh != 0.0 or opt.stop_thresh > 0.0:
        raise ValueError(
            f"{who} requires exact-mode options (sigma_thresh=0, "
            "stop_thresh=0): the thresholded tape backward falls back "
            "to a march over the stored rays, which the packed training "
            "source does not carry"
        )


def train_minibatches(source, ids_batches, targets, features,
                      opt: RenderOptions, *,
                      lr: float = 1e-2,
                      update_fn: Optional[Callable] = None,
                      update_state=(),
                      spec=None, index_table=None,
                      chunk_size: int = 512, r_quant: int = 16,
                      loss_cols: Optional[int] = None,
                      prog_K: int = 0, bwd_prog_K: int = 0):
    """N sequential SGD steps over N random-ray minibatches in ONE
    dispatch — the canonical random-pixel training loop at tape rates.

    Per step n: gather minibatch n's NON-ZERO rows from the packed
    source (in-graph; zero-occupancy rays replay to the background
    constant without touching tape data), replay forward, L2 loss
    against ``targets`` rows, tape backward (bulk flush), apply
    ``update_fn`` (default SGD with ``lr``); step n+1 replays against
    the UPDATED features — a true sequential chain, nothing hoists.

    All N steps share one conservative round program (per-chunk cap =
    max over the N batches): rounds past a batch's true cap have
    valid == all-false and are exact no-ops, so outputs/grads equal the
    per-batch programs'. The shared program + size-bucketed tape width
    keep the executable reusable across calls with same-shaped batches.

    LOSS SCOPE: the reported per-step loss sums squared error over the
    batch's NON-ZERO-OCCUPANCY rays only (divided by batch_size x W).
    Zero-occupancy rays render the exact background constant regardless
    of features — their loss terms carry ZERO gradient — so excluding
    them changes no update while keeping the per-step target gather and
    the host->device index traffic proportional to the rays that do
    work. Add the
    constant yourself if you need the full L2 value.

    :param ids_batches: (N, B) host int array of ray ids per step.
    :param targets: (n_rays, W) device/host array of per-ray targets in
        ORIGINAL ray order; each step compares its rays' outputs
        (first W columns, or ``loss_cols``) against these rows.
    :param update_fn: ``(features, grad, state) -> (features, state)``;
        default plain SGD. State is scanned through (e.g. momentum).
        Pass a stable function object — a fresh lambda per call
        recompiles.
    :param prog_K / bwd_prog_K: subset replay round-size overrides
        (compact parents only — the regroup license; 0 = inherit).
    :return: (features_out, losses (N,), update_state_out) — feed the
        state back into the next call for stateful optimizers (Adam,
        momentum).

    PIPELINING: pass a pre-built :func:`prep_minibatches` pack as
    ``ids_batches`` to overlap the host-side prep of the NEXT batch set
    with the device executing this one (dispatches are async — prep
    while the previous call's outputs are still in flight, fetch after).
    """
    if isinstance(source, RayTape):
        source = TapeRowSource(source)
    if isinstance(ids_batches, MinibatchPack):
        pack = ids_batches
        base = _SrcMeta.of(source)
        got = dataclasses.replace(pack.meta, prog_K=base.prog_K,
                                  bwd_prog_K=base.bwd_prog_K)
        if got != base:
            raise ValueError(
                "MinibatchPack was prepped against a different source "
                f"(geometry/pool mismatch: {pack.meta} vs {base})"
            )
    else:
        pack = prep_minibatches(source, ids_batches,
                                chunk_size=chunk_size, r_quant=r_quant,
                                prog_K=prog_K, bwd_prog_K=bwd_prog_K)
    _check_exact(opt, "train_minibatches")
    targets = jnp.asarray(targets)
    features = jnp.asarray(features)
    W = int(loss_cols) if loss_cols else int(targets.shape[1])
    upd = update_fn if update_fn is not None else _sgd(float(lr))
    return _train_impl(
        source.packed, pack.programs, jnp.asarray(pack.pos_nz),
        jnp.asarray(pack.tgt_idx_nz), targets, features, update_state,
        spec, index_table, opt, plan_meta=pack.plan_meta,
        meta=pack.meta, W=W, upd=upd,
    )


@dataclasses.dataclass(frozen=True)
class MinibatchPack:
    """Host-side product of :func:`prep_minibatches` — everything
    train_minibatches needs besides device data. Build the NEXT pack
    while the device runs the current dispatch (input-pipeline
    prefetch)."""

    pos_nz: np.ndarray      # (N, (n_chunks - n_zero) * C) int32
    tgt_idx_nz: np.ndarray  # (N, (n_chunks - n_zero) * C) int32
    programs: tuple         # jnp round programs (shared, conservative)
    plan_meta: tuple        # (B, C, pad, n_chunks, n_zero, S)
    meta: "_SrcMeta"


def prep_minibatches(source, ids_batches, *, chunk_size: int = 512,
                     r_quant: int = 16, prog_K: int = 0,
                     bwd_prog_K: int = 0) -> MinibatchPack:
    """Host-only phase of :func:`train_minibatches`: per-batch count
    sort + common layout + shared conservative round program. Pure
    NumPy except the (tiny) program arrays; run it for batch set i+1
    while the device executes batch set i."""
    ids_batches = np.asarray(ids_batches)
    if ids_batches.ndim != 2:
        raise ValueError("ids_batches must be (N, B)")
    if isinstance(source, RayTape):
        source = TapeRowSource(source)
    N, B = ids_batches.shape
    plans = [source.prep(ids_batches[n], chunk_size=chunk_size,
                         r_quant=r_quant) for n in range(N)]
    p0 = plans[0]
    # Common layout: width/zero-prefix must be safe for every batch.
    S_com = max(p.S for p in plans)
    n_zero = min(p.n_zero for p in plans)
    n_chunks, C, pad = p0.n_chunks, p0.C, p0.pad
    # Shared conservative caps: per-chunk max over batches, re-aligned
    # to the common zero prefix (chunks a batch skips have cap<=its own
    # caps anyway — a smaller common n_zero only prepends no-op chunks).
    caps = np.zeros((N, n_chunks - n_zero), np.int64)
    for n, p in enumerate(plans):
        caps[n, p.n_zero - n_zero:] = np.minimum(p.caps_nz, S_com)
    caps_sh = caps.max(axis=0)
    meta = _SrcMeta.of(source)
    if prog_K or bwd_prog_K:
        meta = dataclasses.replace(
            meta,
            prog_K=int(prog_K) or meta.prog_K,
            bwd_prog_K=int(bwd_prog_K) or meta.bwd_prog_K,
        )
    programs = _programs(caps_sh, meta.prog_K, meta.bwd_prog_K,
                         S_com, r_quant)
    # Only the non-zero suffix ships and gathers (prefix rays replay to
    # the background constant, zero gradient — see LOSS SCOPE).
    nzr = n_zero * C
    pos_nz = np.stack([p.pos_p[nzr:] for p in plans]).astype(np.int32)
    tgt_idx_nz = np.stack(
        [p.ids_p[nzr:] for p in plans]).astype(np.int32)
    return MinibatchPack(
        pos_nz=pos_nz, tgt_idx_nz=tgt_idx_nz, programs=programs,
        plan_meta=(B, C, pad, n_chunks, n_zero, S_com), meta=meta,
    )


@functools.partial(
    jax.jit,
    static_argnames=("opt", "plan_meta", "meta", "W", "upd"),
)
def _train_impl(packed, programs, pos_nz, tgt_idx_nz, targets, features,
                update_state, spec, index_table, opt, *, plan_meta,
                meta, W, upd):
    B, C, pad, n_chunks, n_zero, S = plan_meta
    Bp = n_chunks * C
    nzr = n_zero * C
    # pad rows duplicate a real ray at layout rows [0, pad); when the
    # zero prefix is empty they fall inside the suffix — mask them from
    # the loss (their cotangent is 0, so no gradient double-counts).
    mask = (jnp.arange(nzr, Bp) >= pad).astype(targets.dtype)
    inv_dummy = jnp.zeros((B,), jnp.int32)
    denom = 1.0 / float(max(B * W, 1))
    zeros3 = jnp.zeros((n_chunks, C, 3), targets.dtype)

    plan = _SubsetPlan(
        pos_p=None, ids_p=None, caps_nz=None, inv=None, B=B, C=C,
        pad=pad, n_chunks=n_chunks, n_zero=n_zero, S=S, r_quant=0,
    )

    def step(carry, xs):
        f, state = carry
        pos, tidx = xs
        arrays = _gather_subset(packed, meta, pos, S, C, n_chunks,
                                n_zero, want_t=False)
        tape = _build_tape(meta, plan, arrays, programs, inv_dummy,
                           zeros3, zeros3)
        tgt = jnp.take(targets, tidx, axis=0)

        def loss_fn(ff):
            out = _replay_call(tape, ff, index_table, opt, spec)
            err = (out[nzr:, :W] - tgt[:, :W]) * mask[:, None]
            return jnp.sum(err * err) * denom

        loss, g = jax.value_and_grad(loss_fn)(f)
        f, state = upd(f, g, state)
        return (f, state), loss

    (features, update_state), losses = jax.lax.scan(
        step, (features, update_state), (pos_nz, tgt_idx_nz)
    )
    return features, losses, update_state


def train_steps(tape: RayTape, targets, features, opt: RenderOptions,
                n_steps: int, *, lr: float = 1e-2,
                update_fn: Optional[Callable] = None, update_state=(),
                spec=None, index_table=None,
                loss_cols: Optional[int] = None):
    """N sequential full-batch SGD steps over ONE recorded tape in ONE
    dispatch — the fixed-ray training chain (every step sees every
    recorded ray; for random minibatches use :func:`train_minibatches`).

    Step n: replay forward, L2 loss against ``targets`` (original ray
    order, permuted into tape order once up front), tape backward (bulk
    flush), update; step n+1 replays the UPDATED features. The chain is
    truly sequential — each step's flush feeds the next forward — so
    per-step cost is the honest fwd+bwd+update floor with zero dispatch
    overhead amortized across ``n_steps``.

    :param targets: (n_rays, W) per-ray target rows, original order.
    :return: (features_out, losses (n_steps,), update_state_out).
    """
    targets = jnp.asarray(targets)
    features = jnp.asarray(features)
    W = int(loss_cols) if loss_cols else int(targets.shape[1])
    upd = update_fn if update_fn is not None else _sgd(float(lr))
    Bp = tape.n_chunks * tape.C
    pad = Bp - tape.n_rays
    # tape-order targets: row inv_pos[i] <- targets[i]; pad rows (the
    # leading duplicate block) keep zeros and are masked out below.
    tgt_tape = jnp.zeros((Bp, W), targets.dtype).at[tape.inv_pos].set(
        targets[:, :W]
    )
    return _train_steps_impl(
        tape, tgt_tape, features, update_state, spec, index_table, opt,
        n_steps=int(n_steps), W=W, pad=pad, upd=upd,
    )


@functools.partial(
    jax.jit, static_argnames=("opt", "n_steps", "W", "pad", "upd"),
)
def _train_steps_impl(tape, tgt_tape, features, update_state, spec,
                      index_table, opt, *, n_steps, W, pad, upd):
    Bp = tape.n_chunks * tape.C
    mask = (jnp.arange(Bp) >= pad).astype(tgt_tape.dtype)
    denom = 1.0 / float(max((Bp - pad) * W, 1))

    def step(carry, _):
        f, state = carry

        def loss_fn(ff):
            out = _replay_call(tape, ff, index_table, opt, spec)
            err = (out[:, :W] - tgt_tape) * mask[:, None]
            return jnp.sum(err * err) * denom

        loss, g = jax.value_and_grad(loss_fn)(f)
        f, state = upd(f, g, state)
        return (f, state), loss

    (features, update_state), losses = jax.lax.scan(
        step, (features, update_state), None, length=n_steps
    )
    return features, losses, update_state
