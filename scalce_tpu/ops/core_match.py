"""LCE tokenizer / core matcher — the device replacement for the
reference's per-read trie scan.

The reference walks a trie of LCP-derived core substrings at every
position of every read, serially, and picks the highest-priority hit
[REF: scalce reads.c core scan — UNVERIFIED; SURVEY.md §4.1 hot loop #1,
"dominant CPU cost"].  On the device this becomes a fully data-parallel
computation over a ``[B, L]`` block:

  1. rolling 2-bit k-mer codes at every position (k static, from Config),
  2. a fixed pseudo-random priority for every k-mer (``mix32`` — the
     implicit dictionary; see ``scalce_tpu.ops.bitops.mix32``) or an
     explicit rank LUT gather (``models.core_dict``),
  3. masked argmin over positions -> (core k-mer, core position) per read.

Reads whose every window is invalid (shorter than k, or covered by
non-ACGT exceptions) land in the sentinel bucket ``NO_CORE``, mirroring
the reference's special bucket for unmatched/N reads (SURVEY.md §2
"LCE tokenizer": "reads with no core / with N -> special buckets").
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from scalce_tpu.ops.bitops import U32, U32_MAX, mix32, pack_bases_u32

#: Bucket key for reads with no valid core window (sorts after all cores).
NO_CORE = U32_MAX


def rolling_kmers(codes: jnp.ndarray, k: int) -> jnp.ndarray:
    """2-bit k-mer code at every start position.

    codes: uint8 ``[B, L]`` with values 0..3.  Returns uint32 ``[B, P]``
    with ``P = L - k + 1``; position ``p`` holds the big-endian packing
    of ``codes[:, p:p+k]``.  Implemented as k shifted adds — O(k·B·P)
    elementwise work with no sequential dependence (vs the reference's
    per-position rescan).
    """
    B, L = codes.shape
    P = L - k + 1
    acc = jnp.zeros((B, P), dtype=U32)
    for i in range(k):
        acc = acc | (codes[:, i:i + P].astype(U32) << (U32(2 * (k - 1 - i))))
    return acc


def window_invalid(exc: jnp.ndarray, lengths: jnp.ndarray,
                   k: int) -> jnp.ndarray:
    """Boolean ``[B, P]``: window at p is unusable (past end or touches
    a non-ACGT exception byte)."""
    B, L = exc.shape
    P = L - k + 1
    csum = jnp.cumsum(exc.astype(jnp.int32), axis=1)
    csum = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), csum], axis=1)
    any_exc = (csum[:, k:] - csum[:, :P]) > 0
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    past_end = pos > (lengths[:, None] - k)
    return any_exc | past_end


def find_cores(codes: jnp.ndarray, lengths: jnp.ndarray,
               exc: jnp.ndarray, k: int, seed: int,
               rank_lut: Optional[jnp.ndarray] = None
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-read core selection.

    Returns ``(core_kmer u32 [B], core_pos i32 [B])``.  ``core_kmer`` is
    ``NO_CORE`` for reads without any valid window.

    rank_lut: optional explicit priority table over all ``4**k`` k-mers
    (uint32, lower = higher priority) — the explicit-dictionary mode
    matching the reference's shipped core table.  ``None`` selects the
    implicit ``mix32`` ranking (default; no memory traffic).
    """
    kmers = rolling_kmers(codes, k)
    if rank_lut is not None:
        rank = rank_lut[kmers]
    else:
        rank = mix32(kmers, seed)
    rank = jnp.where(window_invalid(exc, lengths, k), U32_MAX, rank)
    # argmin over positions; ties -> lowest position (argmin is first-hit)
    core_pos = jnp.argmin(rank, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(rank, core_pos[:, None].astype(jnp.int32),
                               axis=1)[:, 0]
    core_kmer = jnp.take_along_axis(kmers, core_pos[:, None], axis=1)[:, 0]
    core_kmer = jnp.where(best == U32_MAX, NO_CORE, core_kmer)
    core_pos = jnp.where(best == U32_MAX, 0, core_pos)
    return core_kmer, core_pos


def reverse_complement(codes: jnp.ndarray, lengths: jnp.ndarray
                       ) -> jnp.ndarray:
    """Per-read reverse complement within each read's length.

    codes uint8 [B, L] (A=0,C=1,G=2,T=3; complement = 3-x); padding
    stays zeroed.  Strand-canonical bucketing needs both orientations:
    a read and its reverse-complement copy must land in the same bucket
    (real sequencers emit both strands; the reference's core matching
    is strand-sensitive, which this improves on).
    """
    B, L = codes.shape
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    src = lengths[:, None] - 1 - col
    valid = src >= 0
    flipped = jnp.take_along_axis(codes, jnp.maximum(src, 0), axis=1)
    return jnp.where(valid, 3 - flipped, 0).astype(jnp.uint8)


def _shift_left_cols(arr: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """``out[:, j] = arr[:, j + s]`` (zeros shifted in), ``s`` a traced
    scalar in [0, L].  One pad + one contiguous ``dynamic_slice`` — the
    building block of the uniform-length fast paths below, in place of
    a per-element [B, L] ``take_along_axis``."""
    B, L = arr.shape
    padded = jnp.concatenate([arr, jnp.zeros((B, L), arr.dtype)], axis=1)
    return jax.lax.dynamic_slice(padded, (jnp.int32(0), s.astype(jnp.int32)),
                                 (B, L))


def _flip_uniform(arr: jnp.ndarray, l: jnp.ndarray) -> jnp.ndarray:
    """Row reversal within the common length ``l`` (traced scalar) when
    EVERY row has length l: full static flip + global column shift.
    Identical values to the per-row gather formulation."""
    L = arr.shape[1]
    return _shift_left_cols(arr[:, ::-1], jnp.int32(L) - l.astype(jnp.int32))


def reverse_complement_uniform(codes: jnp.ndarray, l: jnp.ndarray
                               ) -> jnp.ndarray:
    """``reverse_complement`` for blocks whose reads all share length
    ``l`` (the overwhelmingly common FASTQ shape): gather-free."""
    L = codes.shape[1]
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    flipped = _flip_uniform(codes, l)
    return jnp.where(col < l, 3 - flipped, 0).astype(jnp.uint8)


def revcomp_kmer(kmers: jnp.ndarray, k: int) -> jnp.ndarray:
    """Reverse-complement of 2-bit-packed k-mers, bit-twiddled in place.

    Complement is bitwise NOT of the 2k low bits; base order reverses by
    swapping 2-bit groups (bytewise swaps, ~10 elementwise ops) — far
    cheaper to COMPILE and run than a second rolling scan over the RC
    read.
    """
    from scalce_tpu.ops.bitops import rev_lanes_u32
    v = rev_lanes_u32((~kmers).astype(U32))
    return v >> (32 - 2 * k)


def find_cores_canonical(codes: jnp.ndarray, lengths: jnp.ndarray,
                         exc: jnp.ndarray, k: int, seed: int,
                         rank_lut: Optional[jnp.ndarray] = None,
                         uniform: bool = False):
    """Core selection over BOTH strands.

    Returns (core_kmer, core_pos, is_rc, codes_oriented, exc_oriented):
    the orientation with the lower-ranked core wins (ties -> forward),
    so RC duplicates choose the same bucket and orientation.

    One rolling pass serves both strands: the RC read's k-mer at RC
    position p' equals ``revcomp_kmer`` of the forward k-mer at
    ``len - k - p'``, and window validity is mirror-symmetric.

    uniform: STATIC flag the caller sets when every read in the block
    has the same length (checked on host).  Selects a gather-free
    orientation path (flip + dynamic_slice) producing bit-identical
    results.
    """
    L = codes.shape[1]
    kmers = rolling_kmers(codes, k)
    invalid = window_invalid(exc, lengths, k)
    rkmers = revcomp_kmer(kmers, k)
    if rank_lut is not None:
        rank_f = rank_lut[kmers]
        rank_r = rank_lut[rkmers]
    else:
        rank_f = mix32(kmers, seed)
        rank_r = mix32(rkmers, seed)
    rank_f = jnp.where(invalid, U32_MAX, rank_f)
    rank_r = jnp.where(invalid, U32_MAX, rank_r)

    pf = jnp.argmin(rank_f, axis=1).astype(jnp.int32)
    bf = jnp.take_along_axis(rank_f, pf[:, None], axis=1)[:, 0]
    # for the RC strand, argmin over forward positions; RC-frame
    # position is len - k - p.  Tie-break must be on the RC-frame
    # position (first occurrence there = LAST forward position), so
    # argmin runs on the reversed axis.
    pr_rev = jnp.argmin(rank_r[:, ::-1], axis=1).astype(jnp.int32)
    p_fwd = rank_r.shape[1] - 1 - pr_rev
    br = jnp.take_along_axis(rank_r, p_fwd[:, None], axis=1)[:, 0]
    kf_v = jnp.take_along_axis(kmers, pf[:, None], axis=1)[:, 0]
    kr_v = jnp.take_along_axis(rkmers, p_fwd[:, None], axis=1)[:, 0]

    use_rc = br < bf
    best = jnp.where(use_rc, br, bf)
    pr = lengths - k - p_fwd          # position in the RC-oriented read
    ck = jnp.where(best == U32_MAX, NO_CORE,
                   jnp.where(use_rc, kr_v, kf_v))
    cp = jnp.where(best == U32_MAX, 0,
                   jnp.where(use_rc, pr, pf)).astype(jnp.int32)
    use_rc = use_rc & (best != U32_MAX)
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    if uniform:
        l = lengths[0]
        rc_codes = reverse_complement_uniform(codes, l)
        exc_rc = _flip_uniform(exc, l) & (col < l)
    else:
        rc_codes = reverse_complement(codes, lengths)
        src = jnp.maximum(lengths[:, None] - 1 - col, 0)
        exc_rc = jnp.take_along_axis(exc, src, axis=1) \
            & (col < lengths[:, None])
    codes_o = jnp.where(use_rc[:, None], rc_codes, codes)
    exc_o = jnp.where(use_rc[:, None], exc_rc, exc)
    return ck, cp, use_rc, codes_o, exc_o


def build_sort_keys(codes: jnp.ndarray, lengths: jnp.ndarray,
                    core_kmer: jnp.ndarray, core_pos: jnp.ndarray,
                    n_reads: jnp.ndarray,
                    suffix_words: int = 2) -> Tuple[jnp.ndarray, ...]:
    """Lexicographic sort keys that realise the reference's bucket order.

    The reference flushes buckets in core order and sorts reads within a
    bucket so overlapping content aligns [REF: scalce compress.c flush —
    UNVERIFIED; SURVEY.md §2 "Bucket manager"].  Here the whole block is
    ordered by one stable multi-key sort:

      key0   core k-mer            (bucket identity; NO_CORE sorts last)
      key1.. bases from the core position onward, 16 per u32 word
             (aligns reads on their shared core, so neighbours in the
             sorted order overlap maximally)
      last   row index             (stability / padding rows to the end)

    Padded rows (row >= n_reads) get all-ones keys so they sort after
    every real read.
    """
    B, L = codes.shape
    # Suffix extraction works on the 2-bit PACKED rows with word-level
    # funnel shifts: suffix_words+1 u32 words per row instead of a
    # [B, 16*suffix_words] per-element gather.  Bit-identical to
    # packing a per-base gather: bases at idx >= lengths are masked to
    # 0 before packing either way.
    if L % 16:                 # config pins L%16==0; pad for odd tests
        codes = jnp.concatenate(
            [codes, jnp.zeros((B, 16 - L % 16), codes.dtype)], axis=1)
    words = pack_bases_u32(codes, axis=1)          # [B, W] big-endian
    W = words.shape[1]
    pad = jnp.zeros((B, suffix_words + 1), U32)
    words_p = jnp.concatenate([words, pad], axis=1)
    w0 = (core_pos >> 4).astype(jnp.int32)         # first word index
    s = (2 * (core_pos & 15)).astype(U32)          # bit offset (0..30)
    if W <= 16:
        # w0 takes at most W values (core_pos < L): the per-row window
        # gather dissolves into W static-slice select-sums at fused
        # elementwise cost (same trick as the delta's shifted windows).
        # Larger L keeps the gather — the unroll would bloat the graph.
        g = jnp.zeros((B, suffix_words + 1), U32)
        for wi in range(W):
            g = g | jnp.where((w0 == wi)[:, None],
                              words_p[:, wi:wi + suffix_words + 1],
                              U32(0))
    else:
        widx = w0[:, None] + jnp.arange(suffix_words + 1,
                                        dtype=jnp.int32)[None, :]
        g = jnp.take_along_axis(words_p, widx, axis=1)  # [B, sw+1]
    a, b = g[:, :-1], g[:, 1:]
    lo = jnp.where(s[:, None] == 0, U32(0),
                   b >> (U32(32) - s[:, None]))     # s=0 lane discarded
    suffix = (a << s[:, None]) | lo                 # [B, suffix_words]
    # zero bases past each read's length: keep the top 2v bits of word j
    # where v = #valid bases from core_pos + 16j
    j16 = 16 * jnp.arange(suffix_words, dtype=jnp.int32)[None, :]
    v = jnp.clip(lengths[:, None] - core_pos[:, None] - j16, 0, 16)
    full = jnp.uint32(0xFFFFFFFF)
    keep = jnp.where(v <= 0, U32(0),
                     jnp.where(v >= 16, full,
                               full << (U32(32) - 2 * v.astype(U32))))
    suffix = suffix & keep

    row = jnp.arange(B, dtype=U32)
    pad = row >= n_reads.astype(U32)
    key0 = jnp.where(pad, U32_MAX, core_kmer)
    keys = [key0]
    for w in range(suffix_words):
        keys.append(jnp.where(pad, U32_MAX, suffix[:, w]))
    keys.append(row)
    return tuple(keys)
