"""Quality stream codec: context-modelled interleaved rANS.

Replaces the reference's adaptive order-k arithmetic coder over quality
symbols [REF: scalce arithmetic.c + qualities path — UNVERIFIED;
SURVEY.md §2 "Quality codec (lossless)"] with the two-pass static-table
scheme of ``scalce_tpu.ops.rans``.

Context model (shared bit-exactly by encode and decode):

  PAD (ctx 0)      padding positions past a read's length — frequency
                   mass collapses to symbol 0, so padding costs 0 bits
                   and 0 extra branches on device.
  order-1          ctx = 1 + pos_bucket(8)*95 + prev1_full(94 + start)
  order-2          8 pos buckets x 25-level prev1 quant x 7-level prev2
                   quant (richer history, smaller table than o3).
  order-3          ctx = 1 + pos_bucket32(col/4)*95 + prev1_full — the
                   position-adaptive-width model (EXPERIMENTS.md §2);
                   4x the table, wins on position-structured platforms.
  order 0 (config) per-block auto-trial across all three.

Symbols are ``quality_byte - 33`` (FASTQ range '!'..'~', 94 values).

Lane layout: reads are padded to a common L, so flattening ``[B, L]``
row-major IS the lane-major span layout ``ops.rans`` wants, with
``T = k*L`` making every lane own k whole reads — contexts never cross
lanes, and at scan step t every lane sits at the same column ``t % L``
(this is what makes the decode-side context recomputation cheap: the
position part of the context is a per-step scalar, only the
previous-symbol part differs per lane).
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from scalce_tpu.models import entropy
from scalce_tpu.ops import rans
from scalce_tpu.ops.bitops import U32

N_SYMS = 94          # printable FASTQ quality range

#: SCALCE_TABLE_PROBE=zlib switches the order auto-trial's table-cost
#: probe from the analytic run-length model back to a measured zlib
#: Z_RLE compress (A/B validation only — see _table_cost_bytes)
_TABLE_PROBE_ZLIB = os.environ.get("SCALCE_TABLE_PROBE", "") == "zlib"
QUAL_OFFSET = 33
_POS_BUCKETS = 8
_PREV1_FULL = 94     # order-1: UNQUANTIZED prev symbol (+ start sentinel).
                     # On serially-correlated qualities (every real
                     # instrument) quantizing prev1 merges exactly the
                     # most likely next values — full prev1 is worth ~6%
                     # of the stream (EXPERIMENTS.md); the o1 decode LUT
                     # stays a manageable 761*4096*4B = 12.5MB
_PREV_LEVELS = 24    # order-2 prev_sym >> 2, clipped (full prev1 x prev2
                     # would need an 87MB decode LUT for <0.2% gain)
_PREV2_LEVELS = 7    # prev2_sym >> 4 (6 levels) + start sentinel
_POS_BUCKETS32 = 32  # order 3: fine position buckets (col/4, capped) x
                     # full prev1 — EXPERIMENTS.md §2's position-adaptive
                     # width row; wins on position-structured platforms,
                     # costs a 4x table (the auto-trial weighs that)


def n_contexts(order: int) -> int:
    if order == 1:
        return 1 + _POS_BUCKETS * (_PREV1_FULL + 1)
    if order == 3:
        return 1 + _POS_BUCKETS32 * (_PREV1_FULL + 1)
    return 1 + _POS_BUCKETS * (_PREV_LEVELS + 1) * _PREV2_LEVELS


def pick_T(B: int, L: int, target: int = 1024) -> int:
    """Span length: a multiple of L so lanes own whole reads; lane count
    N = B*L/T stays a few thousand, wide enough to fill the device."""
    k = max(1, target // L)
    k = 1 << (k.bit_length() - 1)          # power of two
    while B % k:
        k >>= 1
    return k * L


def _pos_bucket(col: jnp.ndarray, order: int = 1) -> jnp.ndarray:
    if order == 3:
        return jnp.minimum(col // 4, _POS_BUCKETS32 - 1).astype(U32)
    return jnp.minimum(col // 16, _POS_BUCKETS - 1).astype(U32)


def _ctx_from(prev1: jnp.ndarray, prev2: jnp.ndarray, pb: jnp.ndarray,
              c0, c1, valid: jnp.ndarray, order: int) -> jnp.ndarray:
    """The one context function used by both encode grid and decode scan."""
    if order == 2:
        pq = jnp.where(c0, U32(_PREV_LEVELS),
                       jnp.minimum(prev1 >> 2, _PREV_LEVELS - 1))
        ctx = pb * U32(_PREV_LEVELS + 1) + pq
        p2 = jnp.where(c0 | c1, U32(_PREV2_LEVELS - 1),
                       jnp.minimum(prev2 >> 4, _PREV2_LEVELS - 2))
        ctx = ctx * U32(_PREV2_LEVELS) + p2
    else:
        pq = jnp.where(c0, U32(_PREV1_FULL),
                       jnp.minimum(prev1, _PREV1_FULL - 1))
        ctx = pb * U32(_PREV1_FULL + 1) + pq
    return jnp.where(valid, ctx + U32(1), U32(0))


def sym_ctx_hist(qual: jnp.ndarray, lengths: jnp.ndarray, order: int
                 ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Device pass A: symbol grid, context grid, (ctx,sym) histogram.

    Plain (un-jitted) so pipelines can fuse it into a larger jit; the
    module-level ``_sym_ctx_hist`` wrapper jits it for standalone use.
    """
    B, L = qual.shape
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    valid = col < lengths[:, None]
    sym = jnp.clip(qual.astype(jnp.int32) - QUAL_OFFSET, 0, N_SYMS - 1)
    sym = jnp.where(valid, sym, 0).astype(U32)
    prev1 = jnp.pad(sym[:, :-1], ((0, 0), (1, 0)))
    prev2 = jnp.pad(sym[:, :-2], ((0, 0), (2, 0)))
    ctx = _ctx_from(prev1, prev2, _pos_bucket(col.astype(U32), order),
                    col == 0, col == 1, valid, order)
    counts = rans.context_histogram(sym.reshape(-1), ctx.reshape(-1),
                                    n_contexts(order), N_SYMS)
    return sym, ctx, counts


_sym_ctx_hist = partial(jax.jit, static_argnames=("order",))(sym_ctx_hist)


@partial(jax.jit, static_argnames=("T",))
def _encode_pass(sym: jnp.ndarray, ctx: jnp.ndarray, freq_lut: jnp.ndarray,
                 cum_lut: jnp.ndarray, T: int):
    states, words, emits = rans.rans_encode(
        sym.reshape(-1), ctx.reshape(-1), freq_lut, cum_lut, N_SYMS, T)
    packed, counts = rans.compact_emissions(words, emits)
    return states, packed, counts


@partial(jax.jit, static_argnames=("order",))
def _normalize_pass(counts: jnp.ndarray, order: int):
    """Device table normalization as its own small jit (the freq/cum
    arrays never leave the device before the encode scan reads them)."""
    return entropy.device_normalize(counts, n_contexts(order), N_SYMS)


@partial(jax.jit, static_argnames=("order", "T", "B", "L"))
def _decode_pass(states: jnp.ndarray, words_padded: jnp.ndarray,
                 decode_lut: jnp.ndarray, lengths: jnp.ndarray,
                 order: int, T: int, B: int, L: int) -> jnp.ndarray:
    k = T // L
    N = B // k
    col = jnp.tile(jnp.arange(L, dtype=jnp.int32), k)          # [T]
    # valid[t, n]: lane n at step t sits in read n*k + t//L, column t%L
    read_of_t = jnp.repeat(jnp.arange(k, dtype=jnp.int32), L)  # [T]
    lane_reads = jnp.arange(N, dtype=jnp.int32)[None, :] * k + read_of_t[:, None]
    valid = col[:, None] < lengths[lane_reads]                  # [T, N]
    aux = {
        "pb": _pos_bucket(col.astype(U32), order),
        "c0": col == 0,
        "c1": col == 1,
        "valid": valid,
    }

    def ctx_fn(aux_t, prev1, prev2):
        return _ctx_from(prev1, prev2, aux_t["pb"], aux_t["c0"],
                         aux_t["c1"], aux_t["valid"], order)

    syms = rans.rans_decode(states, words_padded, decode_lut, ctx_fn,
                            aux, T)                             # [T, N]
    grid = syms.T.reshape(B, L)
    qual = jnp.where(valid.T.reshape(B, L),
                     grid + U32(QUAL_OFFSET), U32(0)).astype(jnp.uint8)
    return qual


_decode_batch_pass = jax.jit(
    jax.vmap(_decode_pass.__wrapped__,
             in_axes=(0, 0, 0, 0, None, None, None, None)),
    static_argnums=(4, 5, 6, 7))


def _decode_batch_args(encs, lengths_list):
    """Host prep of a group quality decode: per-block padded word
    matrices, flat decode LUTs, states and lengths, stacked on a
    leading group axis (NumPy; the caller uploads them)."""
    e0 = encs[0]
    D = len(encs)
    N = e0.states.shape[0]
    from scalce_tpu.io.fastq import ragged_scatter
    # floored bucket (see finish_encoded): keeps the vmapped decode jit
    # from recompiling when a group's max word count crosses a boundary
    W = max(64, e0.T // 8)
    wmax = max((int(e.counts.max()) if len(e.counts) else 0) for e in encs)
    while W < wmax:
        W <<= 1
    words = np.zeros((D, N, W), np.uint16)
    luts = np.empty((D, n_contexts(e0.order) * rans.M_TOTAL), np.uint32)
    states = np.empty((D, N), np.uint32)
    lengths = np.empty((D, e0.B), np.int32)
    for d, e in enumerate(encs):
        ragged_scatter(words[d].reshape(-1),
                       np.arange(N, dtype=np.int64) * W, e.words,
                       e.counts.astype(np.int64))
        cum = entropy.freq_to_cum(e.freq)
        luts[d] = entropy.build_decode_lut(e.freq, cum)
        states[d] = e.states
        lengths[d] = lengths_list[d]
    return states, words, luts, lengths


def decode_batch_dispatch(encs, lengths_list):
    """Host prep + async device dispatch of a group quality decode.

    Returns the (not yet materialized) device array; pair with
    :func:`decode_batch_fetch` — the split lets a pipelined driver run
    the fetch (D2H sync) on a worker thread while the main thread
    dispatches the next group.
    """
    if len({(e.B, e.L, e.T, e.order) for e in encs}) != 1:
        raise ValueError("decode_batch requires uniform (B, L, T, order); "
                         "callers must split mixed-order groups")
    e0 = encs[0]
    args = _decode_batch_args(encs, lengths_list)
    return _decode_batch_pass(*(jnp.asarray(a) for a in args),
                              e0.order, e0.T, e0.B, e0.L)


def decode_batch_fetch(out_dev, D: int):
    out = np.asarray(out_dev)
    return [out[d] for d in range(D)]


def decode_batch(encs, lengths_list):
    """Decode several blocks' quality grids in ONE vmapped scan.

    The decode scan's cost is per-STEP (each step does a table gather),
    not per-lane — so stacking D blocks into the lane dimension decodes
    D blocks for the price of one (SURVEY.md §7 decode GB/s).  Blocks
    must share (B, L, T, order); word matrices are padded to the widest
    bucket in the group.
    """
    return decode_batch_fetch(decode_batch_dispatch(encs, lengths_list),
                              len(encs))


@dataclasses.dataclass
class EncodedQuals:
    """Host-side encoded quality stream for one block."""
    freq: np.ndarray        # uint32 [C, N_SYMS] normalized tables
    states: np.ndarray      # uint32 [N]
    counts: np.ndarray      # int32  [N]
    words: np.ndarray       # uint16 [total] per-lane concatenated
    B: int
    L: int
    T: int
    order: int

    def payload_bytes(self) -> int:
        return (self.words.nbytes + self.states.nbytes + self.counts.nbytes
                + len(entropy.table_payload(self.freq)))


def encode(qual: np.ndarray, lengths: np.ndarray, order: int = 1,
           T_target: int = 1024) -> EncodedQuals:
    """Encode one block's quality grid (uint8 [B, L], int32 [B])."""
    sym, ctx, counts = _sym_ctx_hist(jnp.asarray(qual), jnp.asarray(lengths),
                                     order)
    B, L = qual.shape
    return encode_from_grids(sym, ctx, counts, B, L, order, T_target)


@partial(jax.jit, static_argnames=("W",))
def _slice_words(packed: jnp.ndarray, W: int) -> jnp.ndarray:
    return packed[:, :W]


def encode_from_grids(sym, ctx, counts, B: int, L: int, order: int,
                      T_target: int = 1024) -> EncodedQuals:
    """Pass B given device grids from :func:`sym_ctx_hist` (pipelines fuse
    pass A into their own jit and call this for the table+encode half).

    Tables are normalized ON DEVICE — the stored table is whatever the
    device computed, so decode (which reads it from the container)
    stays bit-exact regardless of the normalization split."""
    T = pick_T(B, L, T_target)
    freq_dev, cum_dev = _normalize_pass(counts, order)
    states, packed, wcounts = _encode_pass(
        sym, ctx, freq_dev.reshape(-1), cum_dev.reshape(-1), T)
    return finish_encoded(np.asarray(freq_dev), np.asarray(states), packed,
                          np.asarray(wcounts), B, L, T, order)


def finish_encoded(freq: np.ndarray, states: np.ndarray, packed,
                   wcounts: np.ndarray, B: int, L: int, T: int,
                   order: int) -> EncodedQuals:
    """Download half of pass B: bucket-slice the padded word matrix on
    device (only the used columns cross to the host), then compact per
    lane."""
    wcounts = wcounts.astype(np.int64)
    # floor the bucket at T/8 so only ~4 slice-width variants exist
    # (each distinct width is a separate jit compile)
    W = max(64, T // 8)
    wmax = int(wcounts.max()) if wcounts.size else 0
    while W < wmax:
        W <<= 1
    packed = np.asarray(_slice_words(packed, min(W, packed.shape[1])))
    from scalce_tpu.io.fastq import ragged_gather
    row_starts = np.arange(packed.shape[0], dtype=np.int64) * packed.shape[1]
    words = ragged_gather(packed.reshape(-1), row_starts, wcounts)
    return EncodedQuals(freq=freq, states=states,
                        counts=wcounts, words=words, B=B, L=L, T=T,
                        order=order)


def decode(enc: EncodedQuals, lengths: np.ndarray) -> np.ndarray:
    """Decode back to the uint8 [B, L] quality grid (padding zeroed)."""
    if np.asarray(lengths).shape[0] != enc.B:
        raise ValueError("corrupt quality stream: lengths/B mismatch")
    N = enc.states.shape[0]
    wmax = int(enc.counts.max()) if N else 0
    # pad word matrix to a floored power-of-two width (same bucket rule
    # as the encode side) to bound recompilations
    W = max(64, enc.T // 8)
    while W < wmax:
        W <<= 1
    from scalce_tpu.io.fastq import ragged_scatter
    words_padded = np.zeros((N, W), dtype=np.uint16)
    counts64 = enc.counts.astype(np.int64)
    ragged_scatter(words_padded.reshape(-1),
                   np.arange(N, dtype=np.int64) * W, enc.words, counts64)
    cum = entropy.freq_to_cum(enc.freq)
    lut = entropy.build_decode_lut(enc.freq, cum)
    qual = _decode_pass(jnp.asarray(enc.states), jnp.asarray(words_padded),
                        jnp.asarray(lut), jnp.asarray(lengths),
                        enc.order, enc.T, enc.B, enc.L)
    return np.asarray(qual)


# ---------------------------------------------------------------------------
# host codec path — bit-identical to the device path by construction
#
# The quality stream needs no device compute: it is permuted (by the
# device-computed sort), remapped, and entropy-coded — all byte-local —
# so the pipeline can keep qualities host-side (Config.qual_on_device=
# False) and skip the raw-quality upload and the word download.
# Every arithmetic step below mirrors the device path exactly (same u32
# coder ops, same f32 normalization via entropy.host_normalize), so the
# two paths emit identical bytes — pinned by tests/test_rans.py.


try:
    from scalce_tpu import native as _native
    _NATIVE_Q = _native.AVAILABLE and hasattr(_native, "rans_encode_lanes")
except Exception:  # pragma: no cover
    _native = None
    _NATIVE_Q = False


def _pos_bucket_np(col: np.ndarray, order: int) -> np.ndarray:
    if order == 3:
        return np.minimum(col // 4, _POS_BUCKETS32 - 1).astype(np.uint32)
    return np.minimum(col // 16, _POS_BUCKETS - 1).astype(np.uint32)


def _ctx_from_np(prev1, prev2, pb, c0, c1, valid, order: int) -> np.ndarray:
    """NumPy mirror of :func:`_ctx_from` (integer ops only)."""
    if order == 2:
        pq = np.where(c0, np.uint32(_PREV_LEVELS),
                      np.minimum(prev1 >> 2, _PREV_LEVELS - 1)
                      ).astype(np.uint32)
        ctx = pb.astype(np.uint32) * np.uint32(_PREV_LEVELS + 1) + pq
        p2 = np.where(c0 | c1, np.uint32(_PREV2_LEVELS - 1),
                      np.minimum(prev2 >> 4, _PREV2_LEVELS - 2)
                      ).astype(np.uint32)
        ctx = ctx * np.uint32(_PREV2_LEVELS) + p2
    else:
        pq = np.where(c0, np.uint32(_PREV1_FULL),
                      np.minimum(prev1, _PREV1_FULL - 1)).astype(np.uint32)
        ctx = pb.astype(np.uint32) * np.uint32(_PREV1_FULL + 1) + pq
    return np.where(valid, ctx + np.uint32(1), np.uint32(0))


def _sym_ctx_np(qual: np.ndarray, lengths: np.ndarray, order: int):
    B, L = qual.shape
    col = np.arange(L, dtype=np.int32)[None, :]
    valid = col < lengths[:, None]
    sym = np.clip(qual.astype(np.int32) - QUAL_OFFSET, 0, N_SYMS - 1)
    sym = np.where(valid, sym, 0).astype(np.uint32)
    prev1 = np.zeros_like(sym)
    prev1[:, 1:] = sym[:, :-1]
    prev2 = np.zeros_like(sym)
    prev2[:, 2:] = sym[:, :-2]
    pb = _pos_bucket_np(col, order)
    ctx = _ctx_from_np(prev1, prev2, pb, col == 0, col == 1, valid, order)
    return sym, ctx, valid


def encode_host(qual: np.ndarray, lengths: np.ndarray, order: int = 1,
                T_target: int = 1024,
                qual_map: Optional[np.ndarray] = None,
                perm: Optional[np.ndarray] = None) -> EncodedQuals:
    """Host-side quality encode (qual already in SORTED order, or in
    ORIGINAL order with the sort permutation passed as ``perm`` — the
    native paths fuse the row gather into the coder's own row copy;
    ``lengths`` are always the SORTED-frame lengths).

    Bit-identical to :func:`encode` / the fused device passes.
    ``order=0`` auto-selects the cheapest of orders 1/2/3 per block by
    table-aware trial cost on the histograms (the adaptivity the
    reference's AC gets for free, recovered at negligible host cost).
    """
    fused = (_NATIVE_Q and hasattr(_native, "qual_hist_one")
             and hasattr(_native, "rans_encode_qual"))
    if qual_map is not None:
        qual_map = np.asarray(qual_map)
        # the lossless identity map is the common case: never worth a
        # 16MB remap gather; the fused native path takes it as a LUT
        if np.array_equal(qual_map, np.arange(256, dtype=np.uint8)):
            qual_map = None
        elif not fused:
            qual = qual_map[qual]
            qual_map = None
    if perm is not None and not fused:
        qual = qual[perm]
        perm = None
    elif perm is not None and hasattr(_native, "permute_rows_u8"):
        # materialize the sorted grid ONCE with the native scatter copy
        # (sequential reads); every later pass then streams it in order.
        # Row-indirecting the passes themselves pays an L3-latency read
        # per row PER PASS (hist + encode + sample = ~30 ms/block worse,
        # measured).  The remap LUT stays fused (clamp_sym_m).
        qual = _native.permute_rows_u8(qual, perm)
        perm = None
    B, L = qual.shape
    lengths = np.asarray(lengths)
    T = pick_T(B, L, T_target)
    if order == 0:
        order = _auto_order(qual, lengths, L, perm, qual_map)
    if _NATIVE_Q and hasattr(_native, "rans_encode_qual"):
        # grid-free path: one single-order histogram pass, then encode
        # straight off the quality grid (contexts recomputed inline,
        # reciprocal divide) — byte-identical to the grid path below
        counts = _native.qual_hist_one(qual, lengths, L, order,
                                       n_contexts(order), perm, qual_map)
        freq, cum = entropy.host_normalize(counts, n_contexts(order),
                                           N_SYMS)
        states, wcounts, words = _native.rans_encode_qual(
            qual, lengths, freq, cum, T, order, perm, qual_map)
        return EncodedQuals(freq=freq, states=states, counts=wcounts,
                            words=words, B=B, L=L, T=T, order=order)
    if _NATIVE_Q:
        sym, ctx, counts = _native.qual_sym_ctx_hist(
            qual, lengths, L, order, n_contexts(order))
        freq, cum = entropy.host_normalize(counts, n_contexts(order),
                                           N_SYMS)
        states, wcounts, words = _native.rans_encode_lanes(
            sym, ctx, freq, cum, B * L // T, T)
        return EncodedQuals(freq=freq, states=states, counts=wcounts,
                            words=words, B=B, L=L, T=T, order=order)
    sym, ctx, _ = _sym_ctx_np(qual, lengths, order)
    idx = ctx.reshape(-1).astype(np.int64) * N_SYMS + sym.reshape(-1)
    counts = np.bincount(idx, minlength=n_contexts(order) * N_SYMS)
    C = n_contexts(order)
    freq, cum = entropy.host_normalize(counts, C, N_SYMS)
    states, words, emits = _host_rans_encode(idx, freq, cum, T)
    wt = words.T                        # [N, T]
    et = emits.T
    return EncodedQuals(freq=freq, states=states,
                        counts=et.sum(axis=1).astype(np.int64),
                        words=wt[et], B=B, L=L, T=T, order=order)


def _table_cost_bytes(freq: np.ndarray) -> int:
    """Estimated stored size of a normalized table (the container
    deflates the u16 image with the file's backend; this probe feeds
    order auto-selection, i.e. OUTPUT BYTES, so it must be identical on
    every host — zlib is always present, zstandard is optional).

    Analytic Z_RLE-class model over the byte image's run structure:
    literal bytes (value changes + the <3-length run residue) cost a
    Huffman-ish ~0.66 bytes, run tokens ~0.5.  Fitted against real
    zlib Z_RLE sizes on order-1/2/3 tables from both synth profiles
    (within ~8%, and the ranking it feeds has table-cost margins far
    wider than that; measured picks unchanged on the bench and hiseq
    corpora).  Replaces a per-block zlib run (~3.5 ms at order-3
    table sizes) with two vectorized passes, and is trivially a pure
    function of the table — no zlib-version dependence at all."""
    img = np.ascontiguousarray(freq.astype("<u2")).view(np.uint8)
    if img.size == 0:
        return 8
    if _TABLE_PROBE_ZLIB:
        # A/B validation fallback (ADVICE r4): the MEASURED Z_RLE size
        # the analytic model was fitted against.  Env-gated because it
        # costs ~3.5 ms/block at order-3 table sizes and ties output
        # bytes to the zlib build; use it to re-check order picks when
        # new corpora land (CLAUDE.md note), not in production.
        co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_RLE)
        return len(co.compress(img.tobytes()) + co.flush()) + 8
    ch = img[1:] != img[:-1]
    nruns = int(np.count_nonzero(ch)) + 1
    # run lengths via change positions; literals = first byte of each
    # run + the tail of runs shorter than 3; tokens = ceil(len/258)
    idx = np.flatnonzero(ch)
    starts = np.empty(nruns, np.int64)
    starts[0] = 0
    starts[1:] = idx + 1
    ends = np.empty(nruns, np.int64)
    ends[:-1] = idx + 1
    ends[-1] = img.size
    rl = ends - starts
    lits = int(np.minimum(rl, 2).sum())
    toks = int(np.ceil((rl[rl >= 3] - 1) / 258.0).sum())
    return int(0.66 * lits + 0.5 * toks) + 16


def _trial_cost(counts: np.ndarray, order: int, scale: float = 1.0) -> float:
    """Total coded bytes under a static table built from ``counts``:
    data bits with the ACTUAL normalized frequencies + table bytes.
    ``scale`` extrapolates sample data bits to the full block (the table
    bytes are a per-block constant and are NOT scaled)."""
    C = n_contexts(order)
    freq, _ = entropy.host_normalize(counts, C, N_SYMS)
    cs = counts.reshape(C, N_SYMS)
    nz = (cs > 0) & (freq > 0)
    bits = (cs[nz] * (rans.PROB_BITS - np.log2(freq[nz]))).sum()
    return bits * scale / 8.0 + _table_cost_bytes(freq)


#: rows used by the order auto-selection trial.  The trial only COMPARES
#: two context models; a 16k-row sample decides that as reliably as the
#: full block while the full histogram pass is paid once, for the chosen
#: order only.  Deterministic (first rows of the sorted block), so
#: output bytes stay a pure function of (block content, config).
_AUTO_SAMPLE_ROWS = 16384


def _auto_order(qual: np.ndarray, lengths: np.ndarray, L: int,
                perm: Optional[np.ndarray] = None,
                qual_map: Optional[np.ndarray] = None) -> int:
    """Per-block order auto-selection (order=0): table-aware trial cost
    for orders 1, 2 and 3 on a deterministic row sample (the first
    sample rows of the SORTED frame, whether materialized or via
    ``perm``); ties favor the smaller-numbered (smaller-table) model."""
    B = lengths.shape[0]
    ns = min(B, _AUTO_SAMPLE_ROWS)
    ls = lengths[:ns]
    if _NATIVE_Q and hasattr(_native, "qual_hist3"):
        counts = _native.qual_hist3(
            qual, ls, L, None if perm is None else perm[:ns], qual_map)
    else:
        qs = qual[:ns] if perm is None else qual[perm[:ns]]
        if qual_map is not None:
            qs = qual_map[qs]
        counts = []
        for o in (1, 2, 3):
            sym, ctx, _ = _sym_ctx_np(qs, ls, o)
            idx = ctx.reshape(-1).astype(np.int64) * N_SYMS \
                + sym.reshape(-1)
            counts.append(np.bincount(idx,
                                      minlength=n_contexts(o) * N_SYMS))
    scale = B / ns
    costs = {o: _trial_cost(c, o, scale)
             for o, c in zip((1, 2, 3), counts)}
    return min((1, 2, 3), key=lambda o: (costs[o], o))


def _host_rans_encode(idx: np.ndarray, freq: np.ndarray, cum: np.ndarray,
                      T: int):
    """NumPy mirror of ops.rans.rans_encode (u32 coder, 16-bit renorm).

    idx: flat ``ctx*N_SYMS + sym`` per symbol, lane-major.  Returns
    (states u32 [N], words u16 [T, N], emits bool [T, N]) with the time
    axis in decode order — identical contract to the device scan."""
    S = idx.shape[0]
    N = S // T
    f_all = freq.reshape(-1)[idx].reshape(N, T).astype(np.uint32)
    c_all = cum.reshape(-1)[idx].reshape(N, T).astype(np.uint32)
    x = np.full(N, 1 << 16, np.uint32)
    words = np.zeros((T, N), np.uint16)
    emits = np.zeros((T, N), bool)
    for t in range(T - 1, -1, -1):
        f = f_all[:, t]
        cm = c_all[:, t]
        emit = (x >> 20) >= f
        words[t] = (x & 0xFFFF).astype(np.uint16)
        x = np.where(emit, x >> 16, x)
        q = x // f
        r = x - q * f
        x = (q << np.uint32(12)) + r + cm
        emits[t] = emit
    return x, words, emits


def decode_host(enc: EncodedQuals, lengths: np.ndarray) -> np.ndarray:
    """Host-side quality decode; same output as :func:`decode`."""
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    if lengths.shape[0] != enc.B:
        raise ValueError("corrupt quality stream: lengths/B mismatch")
    N = enc.states.shape[0]
    T, B, L, order = enc.T, enc.B, enc.L, enc.order
    k = T // L
    cum = entropy.freq_to_cum(enc.freq)
    if _NATIVE_Q and hasattr(_native, "rans_decode_lanes2"):
        # two-level tables: no 12.5MB flat LUT build (that cost more
        # than the decode itself) and no DRAM-latency load per symbol
        return _native.rans_decode_lanes2(enc.states, enc.words,
                                          enc.counts, enc.freq, cum,
                                          np.asarray(lengths), B, L, T,
                                          order)
    lut = entropy.build_decode_lut(enc.freq, cum)
    if _NATIVE_Q:
        return _native.rans_decode_lanes(enc.states, enc.words,
                                         enc.counts, lut,
                                         np.asarray(lengths), B, L, T,
                                         order)
    counts = enc.counts.astype(np.int64)
    W = max(int(counts.max()), 1) if N else 1
    words = np.zeros((N, W + 1), np.uint16)
    fill = np.arange(W)[None, :] < counts[:, None]
    words[:, :W][fill] = enc.words
    lengths = np.asarray(lengths)

    col_t = np.tile(np.arange(L, dtype=np.int32), k)        # [T]
    read_of_t = np.repeat(np.arange(k, dtype=np.int64), L)  # [T]
    lanes = np.arange(N, dtype=np.int64)
    x = enc.states.astype(np.uint32).copy()
    cursor = np.zeros(N, np.int64)
    prev1 = np.zeros(N, np.uint32)
    prev2 = np.zeros(N, np.uint32)
    syms = np.zeros((T, N), np.uint32)
    lane_len = lengths[(lanes[None, :] * k + read_of_t[:, None])]  # [T, N]
    for t in range(T):
        colv = int(col_t[t])
        validt = colv < lane_len[t]
        pb = np.uint32(min(colv // 4, _POS_BUCKETS32 - 1)) if order == 3 \
            else np.uint32(min(colv // 16, _POS_BUCKETS - 1))
        ctx = _ctx_from_np(prev1, prev2, pb, colv == 0, colv == 1,
                           validt, order)
        slot = x & np.uint32(4095)
        e = lut[ctx.astype(np.int64) * 4096 + slot]
        s = e >> np.uint32(24)
        f = ((e >> np.uint32(12)) & np.uint32(4095)) + np.uint32(1)
        cm = e & np.uint32(4095)
        x = f * (x >> np.uint32(12)) + slot - cm
        need = x < np.uint32(1 << 16)
        w = words[lanes, np.minimum(cursor, W)]
        x = np.where(need, (x << np.uint32(16)) | w.astype(np.uint32), x)
        cursor += need
        syms[t] = s
        prev2 = prev1
        prev1 = s
    grid = syms.T.reshape(B, L)
    col = np.arange(L, dtype=np.int32)[None, :]
    valid = col < lengths[:, None]
    return np.where(valid, grid + QUAL_OFFSET, 0).astype(np.uint8)


# ---------------------------------------------------------------------------
# container payload

def payload(enc: EncodedQuals, level: int = 6, backend: str = "gz") -> bytes:
    from scalce_tpu import container
    return container.pack_arrays({
        "dims": np.asarray([enc.B, enc.L, enc.T, enc.order], np.int64),
        "freq": enc.freq.astype(np.uint16),
        "states": enc.states,
        # per-lane word counts are bounded by T: u16 except long-read
        # mode's T = L > 65535 (container v5)
        "counts": enc.counts.astype(np.uint16 if enc.T <= 65535
                                    else np.uint32),
        "words": enc.words,
    }, deflate=("freq", "counts"), level=level, backend=backend)


def parse(blob: bytes) -> EncodedQuals:
    from scalce_tpu import container
    a = container.unpack_arrays(blob)
    if a.get("dims") is None or a["dims"].shape != (4,):
        raise ValueError("corrupt quality stream: bad dims")
    for field in ("freq", "states", "counts", "words"):
        if field not in a:
            raise ValueError(f"corrupt quality stream: missing {field}")
    B, L, T, order = (int(x) for x in a["dims"])
    enc = EncodedQuals(freq=a["freq"].astype(np.uint32),
                       states=a["states"],
                       counts=a["counts"].astype(np.int32),
                       words=a["words"], B=B, L=L, T=T, order=order)
    _validate_enc(enc)
    return enc


def _validate_enc(enc: EncodedQuals) -> None:
    """Reject structurally corrupt quality streams BEFORE any decode —
    the native decoder (host_ops.c rans_decode_lanes2) divides by T and
    walks freq/cum/state/word buffers by these dims, so every size here
    must be proven before the C call (mirrors seqs._validate)."""
    B, L, T, order = enc.B, enc.L, enc.T, enc.order
    if order not in (1, 2, 3):
        raise ValueError("corrupt quality stream: bad order")
    if not (0 <= B <= 1 << 26 and 1 <= L <= 1 << 20 and T >= 1):
        raise ValueError("corrupt quality stream: bad dims")
    if T % L != 0 or (B and ((B * L) % T != 0 or T > B * L)):
        raise ValueError("corrupt quality stream: inconsistent T")
    N = (B * L) // T if B else 0
    C = n_contexts(order)
    if enc.freq.ndim not in (1, 2) or enc.freq.size != C * N_SYMS:
        raise ValueError("corrupt quality stream: bad table size")
    if enc.states.ndim != 1 or enc.states.shape[0] != N:
        raise ValueError("corrupt quality stream: bad states")
    if enc.counts.ndim != 1 or enc.counts.shape[0] != N:
        raise ValueError("corrupt quality stream: bad counts")
    if enc.words.ndim != 1:
        raise ValueError("corrupt quality stream: bad words")
    if N and (int(enc.counts.min()) < 0
              or int(enc.counts.astype(np.int64).sum()) != enc.words.size):
        raise ValueError("corrupt quality stream: words/counts mismatch")
