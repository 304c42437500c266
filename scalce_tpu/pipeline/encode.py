"""Block encode pipeline — the compress driver.

The reference's ``compress()`` owns the per-read hot loop, the bucket
table, flush policy, and part splitting [REF: scalce compress.c —
UNVERIFIED; SURVEY.md §4.1].  Here the whole per-block device work is
ONE fused jit (tokenize → sort → reorder → pack → quality pass A); the
only host syncs per block are the tiny context histogram (to build rANS
tables) and the final payload download — exactly the boundary layout
promised in SURVEY.md §4 ("everything between stays on device").
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from scalce_tpu.config import Config
from scalce_tpu.io.fastq import ReadBlock
from scalce_tpu.ops import core_match, reorder
from scalce_tpu.ops.bitops import U32, pack_bases_u32, \
    rev_lanes_u32 as _rev_lanes
from scalce_tpu.streams import names as names_stream
from scalce_tpu.streams import qualities, seqs


def _encode_core(codes, seq_packed, qual, lengths, n_reads, exc, qual_map,
                 rank_lut, k: int, seed: int, order: int,
                 uniform: bool = False):
    """Shared per-block device stage (codes + its packed image in sync).

    The sequence stream comes out DELTA-CODED against the aligned
    predecessor: after the core sort, neighbouring reads overlap at
    their shared core, so most bases equal the previous read's base at
    a fixed column shift.  The reference leaves this redundancy for
    gzip's LZ window to find [SURVEY.md §1 item 2]; computing the match
    mask explicitly on device is both smaller (~30% on the seq stream)
    and removes the byte-alignment sensitivity of LZ on packed codes.

    Returns (perm, delta dict, sorted lengths, qual sym/ctx grids,
    context histogram).
    """
    del seq_packed
    B, L = codes.shape
    # rank_lut with >1 entry selects the explicit dictionary (its shape
    # is static under jit, so this branch costs nothing)
    lut = rank_lut if rank_lut.shape[0] > 1 else None
    ck, cp, is_rc, codes_o, _ = core_match.find_cores_canonical(
        codes, lengths, exc, k, seed, rank_lut=lut, uniform=uniform)
    keys = core_match.build_sort_keys(codes_o, lengths, ck, cp, n_reads)
    perm = reorder.sort_permutation(keys)
    # reads travel in their strand-canonical orientation with a 1-bit
    # flag; qualities stay in original orientation (streams are
    # independent, and flipping would scramble quality position stats)
    codes_s, qual_s, len_s, ck_s, cp_s, rc_s = reorder.apply_permutation(
        perm, codes_o, qual, lengths, ck, cp, is_rc)
    # qual_map=None means identity (lossless): skips the [B, L] LUT
    # gather
    qual_s = qual_s if qual_map is None else qual_map[qual_s]
    delta = _delta_seq(codes_s, len_s, ck_s, cp_s, n_reads)
    delta["rc_bits"] = _pack_bits(rc_s)
    sym, ctx, counts = qualities.sym_ctx_hist(qual_s, len_s, order)
    return perm, delta, len_s, sym, ctx, counts


def _encode_core_nq(codes, lengths, n_reads, exc, rank_lut, k: int,
                    seed: int, uniform: bool = False):
    """``_encode_core`` for the host-quality placement: sequence side
    only (cores → sort → delta); qualities never reach the device."""
    lut = rank_lut if rank_lut.shape[0] > 1 else None
    ck, cp, is_rc, codes_o, _ = core_match.find_cores_canonical(
        codes, lengths, exc, k, seed, rank_lut=lut, uniform=uniform)
    keys = core_match.build_sort_keys(codes_o, lengths, ck, cp, n_reads)
    perm = reorder.sort_permutation(keys)
    codes_s, len_s, ck_s, cp_s, rc_s = reorder.apply_permutation(
        perm, codes_o, lengths, ck, cp, is_rc)
    delta = _delta_seq(codes_s, len_s, ck_s, cp_s, n_reads)
    delta["rc_bits"] = _pack_bits(rc_s)
    return perm, delta, len_s


def _encode_core_mate2_nq(codes, lengths, n_reads, exc, perm, rank_lut,
                          k: int, seed: int, uniform: bool = False):
    """Mate-2 counterpart of ``_encode_core_nq``."""
    lut = rank_lut if rank_lut.shape[0] > 1 else None
    ck, cp, is_rc, codes_o, _ = core_match.find_cores_canonical(
        codes, lengths, exc, k, seed, rank_lut=lut, uniform=uniform)
    codes_s, len_s, ck_s, cp_s, rc_s = reorder.apply_permutation(
        perm, codes_o, lengths, ck, cp, is_rc)
    delta = _delta_seq(codes_s, len_s, ck_s, cp_s, n_reads)
    delta["rc_bits"] = _pack_bits(rc_s)
    return delta, len_s


def _encode_core_hd(codes, lengths, n_reads, exc, rank_lut, k: int,
                    seed: int, uniform: bool = False):
    """``_encode_core_nq`` for the host-delta placement: device does
    cores → sort and returns only ``[perm, cp|bnd|rc|len]``; the host
    rebuilds the sorted oriented rows from its own copy and runs the
    native delta match (see _hd_pack / _assemble_hd)."""
    lut = rank_lut if rank_lut.shape[0] > 1 else None
    ck, cp, is_rc, codes_o, _ = core_match.find_cores_canonical(
        codes, lengths, exc, k, seed, rank_lut=lut, uniform=uniform)
    keys = core_match.build_sort_keys(codes_o, lengths, ck, cp, n_reads)
    perm = reorder.sort_permutation(keys)
    len_s, ck_s, cp_s, rc_s = reorder.apply_permutation(
        perm, lengths, ck, cp, is_rc)
    return _hd_pack(len_s, ck_s, cp_s, rc_s, perm), perm


def _encode_core_mate2_hd(codes, lengths, n_reads, exc, perm, rank_lut,
                          k: int, seed: int, uniform: bool = False):
    """Mate-2 counterpart of ``_encode_core_hd``."""
    del n_reads
    lut = rank_lut if rank_lut.shape[0] > 1 else None
    ck, cp, is_rc, codes_o, _ = core_match.find_cores_canonical(
        codes, lengths, exc, k, seed, rank_lut=lut, uniform=uniform)
    len_s, ck_s, cp_s, rc_s = reorder.apply_permutation(
        perm, lengths, ck, cp, is_rc)
    return _hd_pack(len_s, ck_s, cp_s, rc_s)


def _encode_core_mate2(codes, qual, lengths, n_reads, exc, perm, qual_map,
                       rank_lut, k: int, seed: int, order: int,
                       uniform: bool = False):
    """Mate-2 shared core: same work as ``_encode_core`` but following
    mate 1's permutation instead of computing one (paired-end sync).
    Mirrors ``_device_stage_a2`` + ``_device_stage_b`` exactly so the
    sharded paired path is byte-identical to the threaded one."""
    lut = rank_lut if rank_lut.shape[0] > 1 else None
    ck, cp, is_rc, codes_o, _ = core_match.find_cores_canonical(
        codes, lengths, exc, k, seed, rank_lut=lut, uniform=uniform)
    codes_s, qual_s, len_s, ck_s, cp_s, rc_s = reorder.apply_permutation(
        perm, codes_o, qual, lengths, ck, cp, is_rc)
    qual_m = qual_s if qual_map is None else qual_map[qual_s]
    delta = _delta_seq(codes_s, len_s, ck_s, cp_s, n_reads)
    delta["rc_bits"] = _pack_bits(rc_s)
    sym, ctx, counts = qualities.sym_ctx_hist(qual_m, len_s, order)
    return delta, len_s, sym, ctx, counts


def _compress_bits(x: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Keep the bits of ``x`` where ``m`` is set, packed toward the LSB
    in order (Hacker's Delight 7-4 parallel-suffix compress) — with
    pair-granular masks this moves 2-bit lanes intact."""
    x = x & m
    mk = (~m) << 1
    for i in range(5):
        mp = mk ^ (mk << 1)
        mp = mp ^ (mp << 2)
        mp = mp ^ (mp << 4)
        mp = mp ^ (mp << 8)
        mp = mp ^ (mp << 16)
        mv = mp & m
        m = (m ^ mv) | (mv >> (1 << i))
        t = x & mv
        x = (x ^ t) | (t >> (1 << i))
        mk = mk & (~mp)
    return x


def _pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    B = bits.shape[0]
    w = jnp.left_shift(jnp.uint8(1), jnp.arange(8, dtype=jnp.uint8))
    return jnp.sum(bits.reshape(B // 8, 8).astype(jnp.uint8) * w[None, :],
                   axis=1, dtype=jnp.uint8)



@partial(jax.jit, static_argnames=("B",))
def _uniform_lengths(n_reads, l0, B: int) -> jnp.ndarray:
    """u16 lengths vector for a uniform block from two scalars."""
    return jnp.where(jnp.arange(B, dtype=jnp.int32) < n_reads,
                     jnp.asarray(l0, jnp.uint16), jnp.uint16(0))


def block_is_uniform(block: ReadBlock) -> bool:
    """Host-side check: every REAL read in the block has the same length
    (padding rows are excluded — their length is 0).  Gates the static
    ``uniform`` fast path of ``core_match.find_cores_canonical``."""
    n = block.n_reads
    if n <= 0:
        return False
    ln = block.lengths[:n]
    return bool(ln.min() == ln.max())


_DELTA_K = 4          # candidate predecessors per read (2-bit selector)
_LONG_SEG_LEN = 512   # long-read multi-anchor TARGET segment length
                      # (container v7; EXPERIMENTS §16: what matters is
                      # segment length vs the inter-indel run length —
                      # ~512 bp keeps segments above the 50% gate down
                      # to ~0.5% indel rates; the per-block nseg is a
                      # pow2 of the MEDIAN read length / 512, clamped
                      # to [4, 256], stored in the container)


def _delta_seq(codes_s, len_s, ck_s, cp_s, n_reads):
    """Aligned-predecessor delta over the sorted block (all vectorized).

    Each read matches against the best of its ``_DELTA_K`` same-bucket
    predecessors (deep buckets contain many mutually-overlapping reads;
    the nearest one is not always the best aligner — best-of-4 cuts
    literals ~25% at high coverage for 2 bits/read of selector).

    Returns dict with:
      mask_bits u8 [B, L//8]  per-position "copy from predecessor" bits
      shifts    i16 [B]       column shift into the chosen predecessor
      pred_k    u8  [B]       chosen predecessor distance minus 1 (0..3)
      lit_packed u32 [B*L//16] literals (non-matching bases), compacted
                               row-major then 2-bit packed (padded)
      n_lits    i32 []        number of literal bases
    """
    B, L = codes_s.shape
    W = L // 16
    col = jnp.arange(L, dtype=jnp.int32)[None, :]
    row = jnp.arange(B, dtype=jnp.int32)
    valid = col < len_s[:, None]

    # The shifted-predecessor compare runs on 2-bit PACKED words with
    # per-row funnel shifts — the same trick the host matcher uses for
    # sort keys — instead of a per-base [B, L] take_along_axis gather:
    # the word-granularity window is 16x smaller, and the funnel and
    # popcount arithmetic is elementwise.  Bit-identical winner
    # selection and match grid (pinned by the device-vs-host delta
    # identity tests).
    P = pack_bases_u32(codes_s, axis=1)              # [B, W] u32 BE
    zpad = jnp.zeros((B, W), U32)
    Ppad = jnp.concatenate([zpad, P, jnp.zeros((B, W + 1), U32)], axis=1)
    base0 = jnp.arange(W, dtype=jnp.int32)[None, :] * 16
    EVEN = U32(0x55555555)

    def shifted_eq(prev_pad, prev_len, shift, row_ok):
        """eq bitmask [B, W] (low bit of each big-endian 2-bit pair set
        where prev[c+shift] == codes[c] AND c is inside the candidate's
        valid interval) — exactly pass 1's same & inb & eq & valid."""
        ws = shift >> 4                              # floor to words
        bs = (U32(2) * (shift & 15).astype(U32))[:, None]
        # per-row shifted window G[r, j] = prev_pad[r, j + ws_r + W]:
        # ws only takes 2W values (|shift| < L), so the row gather
        # dissolves into 2W STATIC slices select-summed — fused
        # elementwise passes
        G = jnp.zeros((B, W + 1), U32)
        for s in range(-W, W):
            G = G | jnp.where((ws == s)[:, None],
                              prev_pad[:, s + W: s + 2 * W + 1], U32(0))
        g0, g1 = G[:, :W], G[:, 1:]
        shifted = jnp.where(bs == 0, g0,
                            (g0 << bs) | (g1 >> (U32(32) - bs)))
        x = shifted ^ P
        eq = (~(x | (x >> 1))) & EVEN
        # per-base conditions are all intervals in c: inb gives
        # c >= -shift and c < prev_len - shift, valid gives c < len
        lo = jnp.maximum(-shift, 0)
        hi = jnp.minimum(len_s.astype(jnp.int32),
                         prev_len.astype(jnp.int32) - shift)
        n1 = jnp.clip(hi[:, None] - base0, 0, 16).astype(U32)
        n0 = jnp.clip(lo[:, None] - base0, 0, 16).astype(U32)
        ones1 = jnp.where(n1 == 0, U32(0),
                          U32(0xFFFFFFFF) << (U32(32) - U32(2) * n1))
        ones0 = jnp.where(n0 == 0, U32(0),
                          U32(0xFFFFFFFF) << (U32(32) - U32(2) * n0))
        return eq & ones1 & ~ones0 \
            & jnp.where(row_ok, EVEN, U32(0))[:, None]

    # pass 1 — pick the winning predecessor by popcount of the packed
    # equality mask (identical counts to the per-base reduction)
    best_count = jnp.full(B, -1, jnp.int32)
    best_shift = jnp.zeros(B, jnp.int32)
    best_k = jnp.zeros(B, jnp.int32)
    for k in range(1, _DELTA_K + 1):
        prev_len = jnp.roll(len_s, k)
        same = (ck_s == jnp.roll(ck_s, k)) & (ck_s != core_match.NO_CORE)
        same = same & (row >= k) & (row < n_reads)
        shift = jnp.where(same, (jnp.roll(cp_s, k) - cp_s).astype(
            jnp.int32), 0)
        eqm = shifted_eq(jnp.roll(Ppad, k, axis=0), prev_len, shift, same)
        cnt = jnp.sum(jax.lax.population_count(eqm), axis=1,
                      dtype=jnp.int32)
        cnt = jnp.where(same, cnt, -1)
        better = cnt > best_count
        best_count = jnp.where(better, cnt, best_count)
        best_shift = jnp.where(better, shift, best_shift)
        best_k = jnp.where(better, k - 1, best_k)

    # pass 2 — rebuild the winning mask ONCE (word-granularity row
    # gather + funnel): bit-identical to selecting it inside the loop,
    # since the winning (same, shift, predecessor) determine its mask
    shift = best_shift
    ok = best_count >= 0
    # winning predecessor rows: best_k takes only _DELTA_K values, so
    # the row gather is a select over static rolls (same trick as the
    # window shift above); rows with row-1-k < 0 have ok=False, so the
    # roll wraparound rows are never read through the masks
    psel = jnp.zeros((B, W), U32)
    lsel = jnp.zeros(B, len_s.dtype)
    for k in range(_DELTA_K):
        is_k = best_k == k
        psel = psel | jnp.where(is_k[:, None], jnp.roll(P, k + 1, axis=0),
                                U32(0))
        lsel = jnp.where(is_k, jnp.roll(len_s, k + 1), lsel)
    prev_pad2 = jnp.concatenate(
        [zpad, psel, jnp.zeros((B, W + 1), U32)], axis=1)
    eqm2 = shifted_eq(prev_pad2, lsel, shift, ok)
    # expand the packed equality bits back to the [B, L] match grid
    # (elementwise repeat + shift — no gather)
    bitpos = (U32(2) * (15 - (col % 16)).astype(U32))
    match = ((jnp.repeat(eqm2, 16, axis=1) >> bitpos) & U32(1)
             ).astype(jnp.bool_)

    # literals: row-major compaction of non-matching valid bases.
    # Two-level instead of one flat [B*L] scatter: (1) compact each
    # row's literals to its front, (2) 2-bit-pack the rows and
    # OR-scatter the WORDS into the global stream at each row's bit
    # offset — 16x fewer scattered elements, identical bytes (zeros
    # beyond each row's count make the word adds disjoint).
    lit_mask = (~match) & valid
    cnt = jnp.sum(lit_mask, axis=1, dtype=jnp.int32)           # [B]
    n_lits = jnp.sum(cnt)
    # per-row literal compaction as a PEXT-style bit network on the
    # packed words (Hacker's Delight 7-4 compress, lane-reversed so
    # the big-endian pair order is preserved): ~60 elementwise ops per
    # u32 word in place of a [B, L] key-value sort.  Kept pairs land
    # TOP-aligned per word, zeros after.
    mbits = pack_bases_u32(jnp.where(lit_mask, 3, 0).astype(jnp.uint8),
                           axis=1)                             # [B, W]
    compw = _rev_lanes(_compress_bits(_rev_lanes(P), _rev_lanes(mbits)))
    wcnt = (jax.lax.population_count(mbits) >> 1).astype(jnp.int32)
    # merge each row's <=W compacted words into a row-local stream:
    # word w's 2*wcnt bits go to row bit offset 2*prefix — the target
    # word index takes only w+1 values, so placement is a select-sum
    rowacc = jnp.zeros((B, W + 1), U32)
    cidx = jnp.arange(W + 1, dtype=jnp.int32)[None, :]
    woff = jnp.zeros(B, jnp.int32)
    for w in range(W):
        v = compw[:, w]
        sh = (U32(2) * (woff.astype(U32) & 15))
        hi = jnp.where(sh == 0, v, v >> sh)
        lo = jnp.where(sh == 0, U32(0), v << (U32(32) - sh))
        j = (woff >> 4)[:, None]
        rowacc = rowacc \
            | jnp.where(cidx == j, hi[:, None], U32(0)) \
            | jnp.where(cidx == j + 1, lo[:, None], U32(0))
        woff = woff + wcnt[:, w]
    prow = rowacc[:, :W]                                       # [B, W]
    off = jnp.cumsum(cnt) - cnt                                # [B]
    sh = (U32(2) * (off % 16).astype(U32))[:, None]
    hi = jnp.where(sh == 0, prow, prow >> sh)
    lo = jnp.where(sh == 0, U32(0), prow << (U32(32) - sh))
    tgt = (off // 16)[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    out = jnp.zeros(B * L // 16 + 1, U32)
    out = out.at[tgt.reshape(-1)].add(hi.reshape(-1), mode="drop")
    out = out.at[(tgt + 1).reshape(-1)].add(lo.reshape(-1), mode="drop")
    lit_packed = out[: B * L // 16]

    bit_w = jnp.left_shift(jnp.uint8(1),
                           jnp.arange(8, dtype=jnp.uint8)[None, None, :])
    mask_bits = jnp.sum(
        match.reshape(B, L // 8, 8).astype(jnp.uint8) * bit_w, axis=2,
        dtype=jnp.uint8)
    return {"mask_bits": mask_bits, "shifts": shift.astype(jnp.int16),
            "pred_k": best_k.astype(jnp.uint8),
            "lit_packed": lit_packed, "n_lits": n_lits}


def _stage_a_prologue(seq_packed, lengths, exc_pos, rank_lut,
                      k: int, seed: int, uniform: bool):
    """Shared stage-A prologue (traced inside each placement's jit):
    unpack the 2-bit H2D words, rebuild the exception mask, and run the
    canonical core matcher.  One
    definition — the six placement wrappers below must never drift on
    the lengths cast / exc scatter / LUT sentinel handling.

    seq_packed: uint32 [B, L//16] host-packed 2-bit codes (quarter-size
    H2D transfer; re-expanded on device).
    exc_pos: int32 [E_pad] flat non-ACGT positions, padded with
    out-of-range sentinels (dropped by the scatter)."""
    from scalce_tpu.ops.bitops import unpack_bases_u32
    lengths = lengths.astype(jnp.int32)   # uploaded as u16 (H2D thrift)
    codes = unpack_bases_u32(seq_packed, axis=1)
    B, L = codes.shape
    exc = jnp.zeros(B * L, jnp.bool_).at[exc_pos].set(
        True, mode="drop").reshape(B, L)
    lut = rank_lut if rank_lut.shape[0] > 1 else None
    ck, cp, is_rc, codes_o, _ = core_match.find_cores_canonical(
        codes, lengths, exc, k, seed, rank_lut=lut, uniform=uniform)
    return lengths, codes_o, ck, cp, is_rc


@partial(jax.jit, static_argnames=("k", "seed", "uniform"))
def _device_stage_a(seq_packed, qual, lengths, n_reads, exc_pos, rank_lut,
                    k: int, seed: int, uniform: bool = False):
    """Device stage A: unpack → canonical cores → sort → orient+permute.

    The single-device pipeline is split into two jits (A: tokenize/sort,
    B: delta/histogram); the extra dispatch costs microseconds.
    """
    lengths, codes_o, ck, cp, is_rc = _stage_a_prologue(
        seq_packed, lengths, exc_pos, rank_lut, k, seed, uniform)
    keys = core_match.build_sort_keys(codes_o, lengths, ck, cp, n_reads)
    perm = reorder.sort_permutation(keys)
    # qualities stay in ORIGINAL orientation: the streams decode
    # independently, and flipping would scramble the position-context
    # statistics of the quality model for no benefit
    codes_s, qual_s, len_s, ck_s, cp_s, rc_s = reorder.apply_permutation(
        perm, codes_o, qual, lengths, ck, cp, is_rc)
    return perm, codes_s, qual_s, len_s, ck_s, cp_s, rc_s


@partial(jax.jit, static_argnames=("order",))
def _device_stage_b(codes_s, qual_s, len_s, ck_s, cp_s, rc_s, n_reads,
                    qual_map, order: int):
    """Device stage B: predecessor delta + quality remap/contexts/histogram.

    qual_map: uint8 [256] quality remap LUT — identity when lossless,
    the lossy quantizer's merge table under ``-p`` (SURVEY.md §4.4:
    "mapping applied per quality byte inside hot loop #1").
    """
    qual_m = qual_s if qual_map is None else qual_map[qual_s]
    delta = _delta_seq(codes_s, len_s, ck_s, cp_s, n_reads)
    delta["rc_bits"] = _pack_bits(rc_s)
    sym, ctx, counts = qualities.sym_ctx_hist(qual_m, len_s, order)
    return delta, sym, ctx, counts


@partial(jax.jit, static_argnames=("k", "seed", "uniform"))
def _device_stage_a_nq(seq_packed, lengths, n_reads, exc_pos, rank_lut,
                       k: int, seed: int, uniform: bool = False):
    """Stage A for the host-quality placement: identical to
    ``_device_stage_a`` minus the quality upload/permute — qualities
    never touch the device (Config.qual_on_device=False), which removes
    the largest H2D transfer ([B, L] u8)."""
    lengths, codes_o, ck, cp, is_rc = _stage_a_prologue(
        seq_packed, lengths, exc_pos, rank_lut, k, seed, uniform)
    keys = core_match.build_sort_keys(codes_o, lengths, ck, cp, n_reads)
    perm = reorder.sort_permutation(keys)
    codes_s, len_s, ck_s, cp_s, rc_s = reorder.apply_permutation(
        perm, codes_o, lengths, ck, cp, is_rc)
    return perm, codes_s, len_s, ck_s, cp_s, rc_s


@jax.jit
def _device_stage_b_nq(codes_s, len_s, ck_s, cp_s, rc_s, n_reads):
    """Stage B for the host-quality placement: predecessor delta only."""
    delta = _delta_seq(codes_s, len_s, ck_s, cp_s, n_reads)
    delta["rc_bits"] = _pack_bits(rc_s)
    return delta


def _hd_pack(len_s, ck_s, cp_s, rc_s, perm=None):
    """Pack the host-delta stage outputs into ONE u32 buffer for a
    single D2H transfer per block.

    The SORTED CODES are deliberately NOT downloaded: the host already
    holds the original-order block and rebuilds the sorted oriented
    rows itself (``native.gather_orient`` — host memcpy instead of a
    D2H plus a device [B, L] row gather).

    Mate-1 layout (``perm`` given — the SORTED frame, where equal cores
    are contiguous runs): ``[perm, cp<<17|bnd<<16|rc<<15|len]``.  The
    4-byte core id is replaced by one run-BOUNDARY bit (bnd = first row
    of its bucket run, or a NO_CORE row); the host delta matcher
    consumes runs directly (``native.delta_match_runs``).

    Mate-2 layout (no ``perm`` — mate-1 order, cores NOT contiguous):
    ``[ck, cp<<16|rc<<15|len]`` (core ids kept).

    cp < L <= 32752 and len <= 32752 both fit 15 bits by config."""
    if perm is None:
        word = ((cp_s.astype(jnp.uint32) << 16)
                | (rc_s.astype(jnp.uint32) << 15)
                | len_s.astype(jnp.uint32))
        parts = [ck_s.astype(jnp.uint32), word]
    else:
        B = ck_s.shape[0]
        prev = jnp.roll(ck_s, 1)
        bnd = (ck_s != prev) | (ck_s == core_match.NO_CORE)
        bnd = bnd | (jnp.arange(B, dtype=jnp.int32) == 0)
        word = ((cp_s.astype(jnp.uint32) << 17)
                | (bnd.astype(jnp.uint32) << 16)
                | (rc_s.astype(jnp.uint32) << 15)
                | len_s.astype(jnp.uint32))
        parts = [perm.astype(jnp.uint32), word]
    return jnp.concatenate(parts)


def _hd_unpack(buf: np.ndarray, B: int, with_perm: bool = True):
    """Host mirror of :func:`_hd_pack`.  Returns ``(perm, key, cp, rc,
    len_s)`` where ``key`` is the boundary-bit vector (mate 1) or the
    core-id vector (mate 2)."""
    perm = None
    w = buf[B:2 * B]
    if with_perm:
        perm = buf[:B].astype(np.int64)
        key = ((w >> 16) & 1).astype(np.uint8)       # run-boundary bits
        cp = (w >> 17).astype(np.int32)
    else:
        key = buf[:B]                                # core ids
        cp = (w >> 16).astype(np.int32)
    rc = ((w >> 15) & 1).astype(np.uint8)
    len_s = (w & 0x7FFF).astype(np.int32)
    return perm, key, cp, rc, len_s


@partial(jax.jit, static_argnames=("k", "seed", "uniform"))
def _device_stage_a_hd(seq_packed, lengths, n_reads, exc_pos, rank_lut,
                       k: int, seed: int, uniform: bool = False):
    """Stage A for the host-delta placement: cores → sort → orient, then
    repack; the delta match itself runs in native C on the host off the
    downloaded sorted block (like the host quality codec)."""
    lengths, codes_o, ck, cp, is_rc = _stage_a_prologue(
        seq_packed, lengths, exc_pos, rank_lut, k, seed, uniform)
    keys = core_match.build_sort_keys(codes_o, lengths, ck, cp, n_reads)
    perm = reorder.sort_permutation(keys)
    len_s, ck_s, cp_s, rc_s = reorder.apply_permutation(
        perm, lengths, ck, cp, is_rc)
    return _hd_pack(len_s, ck_s, cp_s, rc_s, perm), perm


@partial(jax.jit, static_argnames=("k", "seed", "uniform"))
def _device_stage_a2_hd(seq_packed, lengths, exc_pos, perm, rank_lut,
                        k: int, seed: int, uniform: bool = False):
    """Mate-2 stage A for the host-delta placement."""
    lengths, codes_o, ck, cp, is_rc = _stage_a_prologue(
        seq_packed, lengths, exc_pos, rank_lut, k, seed, uniform)
    len_s, ck_s, cp_s, rc_s = reorder.apply_permutation(
        perm, lengths, ck, cp, is_rc)
    return _hd_pack(len_s, ck_s, cp_s, rc_s)


def host_core_available() -> bool:
    try:
        from scalce_tpu import native
        return native.AVAILABLE and hasattr(native, "core_match_block")
    except Exception:
        return False


def host_delta_available() -> bool:
    try:
        from scalce_tpu import native
        return native.AVAILABLE and hasattr(native, "delta_match")
    except Exception:
        return False


@partial(jax.jit, static_argnames=("k", "seed", "uniform"))
def _device_stage_a2_nq(seq_packed, lengths, exc_pos, perm, rank_lut,
                        k: int, seed: int, uniform: bool = False):
    """Mate-2 stage A for the host-quality placement."""
    lengths, codes_o, ck, cp, is_rc = _stage_a_prologue(
        seq_packed, lengths, exc_pos, rank_lut, k, seed, uniform)
    return reorder.apply_permutation(perm, codes_o, lengths, ck, cp, is_rc)


@partial(jax.jit, static_argnames=("k", "seed", "uniform"))
def _device_stage_a2(seq_packed, qual, lengths, exc_pos, perm, rank_lut,
                     k: int, seed: int, uniform: bool = False):
    """Mate-2 stage A: mate 2 follows mate 1's permutation so pairs stay
    line-synchronized (SURVEY.md §2 "Paired-end sync").  Its own cores
    are still computed — not for sorting, but to align the
    predecessor-delta (adjacent pairs usually overlap on mate 2 too)."""
    lengths, codes_o, ck, cp, is_rc = _stage_a_prologue(
        seq_packed, lengths, exc_pos, rank_lut, k, seed, uniform)
    return reorder.apply_permutation(perm, codes_o, qual, lengths, ck,
                                     cp, is_rc)


@partial(jax.jit, static_argnames=("W",))
def _slice_flat(arr: jnp.ndarray, W: int) -> jnp.ndarray:
    return arr[:W]


def _host_pack(codes: np.ndarray) -> np.ndarray:
    """2-bit pack on host (native when available) for the H2D transfer."""
    try:
        from scalce_tpu import native
        if native.AVAILABLE:
            return native.pack2bit(codes)
    except Exception:
        pass
    B, L = codes.shape
    grouped = codes.reshape(B, L // 16, 16).astype(np.uint32)
    shifts = (2 * np.arange(15, -1, -1)).astype(np.uint32)
    return (grouped << shifts).sum(axis=2, dtype=np.uint32)


def _pad_exc(exc_pos: np.ndarray, sentinel: int) -> np.ndarray:
    """Pad to a STABLE default capacity (1.5% of bases) so the common
    case never changes the jit input shape — a new shape recompiles
    stage A.  Blocks with more exceptions fall back to the next power
    of two (rare)."""
    default_cap = max(1024, sentinel // 64)
    n = len(exc_pos)
    if n <= default_cap:
        cap = default_cap
    else:
        cap = 1 << (n - 1).bit_length()
    out = np.full(cap, sentinel, np.int32)
    out[:n] = exc_pos
    return out


@dataclasses.dataclass
class EncodedBlock:
    block_id: int
    n_reads: int
    payloads: Dict[str, bytes]      # 'n' / 'r' / 'q'

    @property
    def total_bytes(self) -> int:
        return sum(len(p) for p in self.payloads.values())


class BlockEncoder:
    """Stateless per-block encoder (safe to drive from a host thread pool:
    jit functions are pure; numpy work is per-block local)."""

    def __init__(self, cfg: Config, qual_map: Optional[np.ndarray] = None):
        self.cfg = cfg
        if qual_map is None:
            from scalce_tpu.models import lossy
            qual_map = lossy.identity_map()
        self.qual_map_np = np.asarray(qual_map)
        self._qual_map_dev = None
        self._rank_lut_dev = None
        #: long-read mode (config gates placements): no core matching /
        #: reorder / delta — identity order, all bases through the
        #: order-2 literal rANS (see config.py for why)
        self.long_mode = cfg.max_read_len > 32752
        # host-delta placement: only meaningful with host-placed
        # qualities (the device-quality graph already holds the sorted
        # block) and a working native library
        self.host_delta = (not cfg.delta_on_device
                           and not cfg.qual_on_device
                           and host_delta_available())
        # host core placement: the whole block pipeline runs on the
        # host (native matcher+sort feeding the same assemble path) —
        # no device traffic at all.  Demands the host delta/qual
        # placements (config validates) and the implicit dictionary.
        # AUTO (None): the device when JAX runs on a GPU, the native
        # host path otherwise (a machine without a GPU).  A visible GPU
        # whose backend fails to initialise raises inside
        # jax.default_backend(); it never turns into the host path.
        eligible = (self.host_delta and cfg.dict_mode == "hash"
                    and not cfg.data_parallel and host_core_available())
        if self.long_mode:
            want_host = False      # long-read path never touches jax
        elif cfg.core_on_device is None:
            want_host = jax.default_backend() != "gpu"
        else:
            want_host = not cfg.core_on_device
        self.host_core = want_host and eligible

    # device constants are built LAZILY: the host-placed pipeline must
    # never touch the device
    @property
    def qual_map(self):
        """Device remap LUT, or None for the lossless identity (the
        jitted stages skip the [B, L] LUT gather on None; None vs array
        retraces, so the branch is static)."""
        if np.array_equal(self.qual_map_np,
                          np.arange(256, dtype=np.uint8)):
            return None
        if self._qual_map_dev is None:
            self._qual_map_dev = jnp.asarray(self.qual_map_np)
        return self._qual_map_dev

    @property
    def rank_lut(self):
        if self._rank_lut_dev is None:
            cfg = self.cfg
            if cfg.dict_mode == "lut":
                from scalce_tpu.models import core_dict
                self._rank_lut_dev = jnp.asarray(
                    core_dict.build_rank_lut(cfg.core_k, cfg.dict_seed))
            elif cfg.dict_mode == "lcp":
                from scalce_tpu.models import core_dict
                self._rank_lut_dev = jnp.asarray(
                    core_dict.build_rank_lut_lcp(cfg.core_k,
                                                 cfg.dict_seed))
            else:
                # single-entry sentinel -> the implicit hash dictionary
                self._rank_lut_dev = jnp.zeros(1, jnp.uint32)
        return self._rank_lut_dev

    # -- stage split: ``encode_device`` runs only device dispatches (kept
    # on the driver's main thread so device work pipelines in submission
    # order); ``assemble`` does D2H + tables + payload bytes and is safe
    # to run on a host worker thread (the reference's -T concurrency,
    # SURVEY.md §2 "Threading", moved to where the host time actually is)

    def upload(self, block: ReadBlock):
        """H2D uploads for one block, runnable on a background thread.

        The driver's upload prefetcher calls this one block AHEAD of
        dispatch so the H2D transfer of the packed seq + exceptions
        overlaps the previous block's device compute instead of
        serializing in front of it (double-buffered H2D, the way D2H
        already uses ``copy_to_host_async``).  Safe because device
        buffers are immutable and the stage jits order themselves
        through data dependencies on these uploads."""
        if self.host_core or self.long_mode:
            return None
        B, L = block.seq.shape
        if block_is_uniform(block):
            # uniform block: synthesize lengths ON DEVICE from two
            # scalars, dropping the u16 lengths upload entirely.  This
            # prefetch thread then dispatches a jit, so device work is
            # not dispatched solely from the main thread (harmless: jit
            # results are immutable and stage order is fixed by data
            # dependencies).
            len_dev = _uniform_lengths(block.n_reads,
                                       int(block.lengths[0]), B)
        else:
            len_dev = jnp.asarray(block.lengths.astype(np.uint16))
        pre = {
            "seq": jnp.asarray(_host_pack(block.seq)),
            "len": len_dev,
            "exc": jnp.asarray(_pad_exc(block.exc_pos.astype(np.int32),
                                        B * L)),
        }
        if self.cfg.qual_on_device:
            pre["qual"] = jnp.asarray(block.qual)
        return pre

    def encode_device(self, block: ReadBlock, pre=None):
        cfg = self.cfg
        if self.long_mode:
            return ("long",)   # host-only long-read path; see assemble
        if self.host_core:
            return ("hc",)     # whole pipeline host-side; see assemble
        if pre is None:
            pre = self.upload(block)
        uni = block_is_uniform(block)
        if self.host_delta:
            buf, perm = _device_stage_a_hd(
                pre["seq"], pre["len"], jnp.int32(block.n_reads),
                pre["exc"],
                self.rank_lut, cfg.core_k, cfg.dict_seed, uniform=uni)
            try:
                buf.copy_to_host_async()   # overlap D2H with later work
            except (AttributeError, NotImplementedError):
                pass
            return ("hd", buf, perm, None, None, None)
        if not cfg.qual_on_device:
            perm, codes_s, len_s, ck_s, cp_s, rc_s = _device_stage_a_nq(
                pre["seq"], pre["len"], jnp.int32(block.n_reads),
                pre["exc"],
                self.rank_lut, cfg.core_k, cfg.dict_seed, uniform=uni)
            delta = _device_stage_b_nq(codes_s, len_s, ck_s, cp_s, rc_s,
                                       jnp.int32(block.n_reads))
            return perm, delta, len_s, None, None, None
        perm, codes_s, qual_s, len_s, ck_s, cp_s, rc_s = _device_stage_a(
            pre["seq"], pre["qual"], pre["len"],
            jnp.int32(block.n_reads), pre["exc"],
            self.rank_lut, cfg.core_k, cfg.dict_seed, uniform=uni)
        delta, sym, ctx, counts = _device_stage_b(
            codes_s, qual_s, len_s, ck_s, cp_s, rc_s,
            jnp.int32(block.n_reads), self.qual_map,
            cfg.qual_context_order)
        return perm, delta, len_s, sym, ctx, counts

    def assemble(self, block: ReadBlock, devout) -> EncodedBlock:
        if isinstance(devout[0], str) and devout[0] == "long":
            return self._assemble_long(block)
        if isinstance(devout[0], str) and devout[0] == "hc":
            return self._assemble_hc(block)
        if isinstance(devout[0], str):     # "hd" marker
            return self._assemble_hd(block, devout[1])
        perm, delta, len_s, sym, ctx, counts = devout
        return self._assemble(block, np.asarray(perm), delta, len_s,
                              sym, ctx, counts)

    def _assemble_hd(self, block: ReadBlock, buf,
                     with_perm: bool = True,
                     perm_np: Optional[np.ndarray] = None) -> EncodedBlock:
        """Host-delta assembly: one D2H of the packed sorted block, then
        the native byte-compare match (bit-identical to _delta_seq)."""
        from scalce_tpu import native
        B, L = block.seq.shape
        p, key, cp, rc, len_s = _hd_unpack(np.asarray(buf), B, with_perm)
        if perm_np is None:
            perm_np = p
        n = block.n_reads
        codes_s = native.gather_orient(block.seq, perm_np[:n], rc[:n],
                                       len_s[:n])
        if with_perm:        # mate-1 sorted frame: run-boundary bits
            mask_bits, shifts, pred_k, lits = native.delta_match_runs(
                codes_s, key[:n], cp[:n], len_s[:n], _DELTA_K)
        else:                # mate-2 (mate-1 order): core ids
            mask_bits, shifts, pred_k, lits = native.delta_match(
                codes_s, key[:n], cp[:n], len_s[:n], _DELTA_K)
        delta_np = {
            "mask_bits": mask_bits, "shifts": shifts, "pred_k": pred_k,
            "rc_bits": np.packbits(rc, bitorder="little"),
            "lits": lits, "n_lits": len(lits),
        }
        return self._assemble(block, perm_np, delta_np, len_s, None,
                              None, None)

    def _assemble_hc(self, block: ReadBlock,
                     perm_np: Optional[np.ndarray] = None,
                     mate2: bool = False, cores=None) -> EncodedBlock:
        """Fully host-side assembly: native canonical matcher + stable
        bucket sort (core_match_block) feeding the same delta/quality
        path as the hd placement — byte-identical to the device stage A
        (pinned by test)."""
        from scalce_tpu import native
        cfg = self.cfg
        B, L = block.seq.shape
        n = block.n_reads
        if cores is None:
            cores = native.core_match_block(
                block.seq, block.lengths, block.exc_pos, n, cfg.core_k,
                cfg.dict_seed)
        ck, cp, rc, perm_n = cores
        if mate2:
            order_n = perm_np[:n]          # follow mate 1's permutation
        else:
            order_n = perm_n
            perm_np = np.concatenate(
                [perm_n, np.arange(n, B, dtype=np.int64)])
        ck_s = ck[order_n]
        cp_s = cp[order_n]
        rc_s = rc[order_n]
        len_n = block.lengths[order_n].astype(np.int64)
        len_s = np.zeros(B, np.int32)
        len_s[:n] = len_n
        codes_s = native.gather_orient(block.seq, order_n, rc_s, len_n)
        if mate2:                          # cores NOT contiguous runs
            mask_bits, shifts, pred_k, lits = native.delta_match(
                codes_s, ck_s, cp_s, len_n, _DELTA_K)
        else:
            bnd = np.ones(n, np.uint8)
            if n > 1:
                bnd[1:] = ((ck_s[1:] != ck_s[:-1])
                           | (ck_s[1:] == np.uint32(core_match.NO_CORE))
                           ).astype(np.uint8)
            mask_bits, shifts, pred_k, lits = native.delta_match_runs(
                codes_s, bnd, cp_s, len_n, _DELTA_K)
        rc_full = np.zeros(B, np.uint8)
        rc_full[:n] = rc_s
        delta_np = {
            "mask_bits": mask_bits, "shifts": shifts, "pred_k": pred_k,
            "rc_bits": np.packbits(rc_full, bitorder="little"),
            "lits": lits, "n_lits": len(lits),
        }
        return self._assemble(block, perm_np, delta_np, len_s, None,
                              None, None)

    def _long_order(self, block: ReadBlock, h=None, mp=None) -> np.ndarray:
        """Deterministic long-read order: (minimizer hash, -pos), stable
        ties; identity when fewer than two reads carry a key."""
        from scalce_tpu.ops.minimizer import NO_KEY, minimizer_keys
        n = block.n_reads
        if h is None:
            h, mp = minimizer_keys(block.seq[:n],
                                   block.lengths[:n].astype(np.int64))
        if n >= 2 and int((h != NO_KEY).sum()) >= 2:
            return np.lexsort((-mp, h)).astype(np.int64)
        return np.arange(n, dtype=np.int64)

    def _assemble_long(self, block: ReadBlock,
                       order_n: Optional[np.ndarray] = None
                       ) -> EncodedBlock:
        """Long-read mode (L > 32752; container v6): minimizer-landmark
        reordering + anchored predecessor delta.

        The short-read core matcher cannot run here (15/16-bit delta
        fields, automaton sized for short reads), but the boosting idea
        carries over: reads are sorted by their GLOBAL MINIMIZER
        (ops/minimizer.py) so overlapping reads become adjacent, and
        each read delta-codes against its immediate predecessor at the
        minimizer-anchored shift (i32 — the v6 ``shv4`` field).  Rows
        whose match rate does not clearly beat the 25% random-alignment
        floor keep an all-zero mask (pure literal fill, the v5
        behavior), so blocks with no overlap round-trip at v5 size +
        a few bytes.  EXPERIMENTS.md §14: 1.7-3.4x on the seq stream at
        5-20x coverage with substitution errors; indel-dominated reads
        fall back to literal rows via the density rule.

        ``order_n``: mate-1's permutation (paired long mode — mate 2
        follows it for pair sync but anchors with its OWN minimizers).
        Qualities/names/exceptions ride the standard reordered-frame
        machinery (perm stored; --keep-order works unchanged).
        """
        from scalce_tpu.ops.minimizer import (NO_KEY, minimizer_keys,
                                              segment_minimizer_keys)
        B, L = block.seq.shape
        n = block.n_reads
        len_n0 = block.lengths[:n].astype(np.int64)
        med = int(np.median(len_n0)) if n else 0
        nseg = 1 << max(2, min(8, (med // _LONG_SEG_LEN).bit_length()))
        h, mp = minimizer_keys(block.seq[:n], len_n0)
        if order_n is None:
            order_n = self._long_order(block, h, mp)
        codes_s = block.seq[:n][order_n]
        len_n = len_n0[order_n]
        h_s = h[order_n]
        mp_s = mp[order_n]
        match = np.zeros((n, L), bool)
        col = np.arange(L, dtype=np.int64)[None, :]
        seg_shift = np.zeros((n, nseg), np.int64)
        if n >= 2:
            same = np.zeros(n, bool)
            same[1:] = (h_s[1:] == h_s[:-1]) & (h_s[1:] != NO_KEY)
            prev_mp = np.zeros(n, np.int64)
            prev_mp[1:] = mp_s[:-1]
            prev_len = np.zeros(n, np.int64)
            prev_len[1:] = len_n[:-1]
            gshift = np.where(same, prev_mp - mp_s, 0)
            # MULTI-ANCHOR (container v7, EXPERIMENTS §16): one fixed
            # shift dies at the first indel after the anchor; instead
            # each of nseg equal spans of the read anchors on any
            # segment minimizer it shares with its predecessor (the
            # global anchor is the fallback), so alignment re-locks
            # after every indel that lands between anchors.  Measured:
            # 1.8x/1.4x/1.1x on 0.2%/0.5%/1% indel synthetics where
            # the v6 single anchor is a no-op; identical behavior on
            # indel-free data (every segment agrees with the global
            # shift there).
            sh_cur, sp_cur = segment_minimizer_keys(codes_s, len_n, nseg)
            sh_prev = np.roll(sh_cur, 1, axis=0)
            sp_prev = np.roll(sp_cur, 1, axis=0)
            seg_shift[:] = gshift[:, None]
            # first-match-wins hash join, vectorized over rows and
            # chunked over the cur-segment axis: the full a x b Python
            # loop was 65,536 numpy passes at nseg=256 (~0.66 s/block),
            # while a single [n, nseg, nseg] broadcast materializes
            # multi-GB bool temporaries at large blocks — nseg passes
            # of [n, nseg] work is both fast and O(n*nseg) memory
            rows_i = np.arange(n)
            for a in range(nseg):
                eq_a = (sh_cur[:, a:a + 1] == sh_prev) \
                    & (sh_cur[:, a:a + 1] != NO_KEY)   # [n, nseg]
                hit = eq_a.any(axis=1) & same
                b_idx = eq_a.argmax(axis=1)            # first True
                matched = sp_prev[rows_i, b_idx] - sp_cur[:, a]
                seg_shift[:, a] = np.where(hit, matched, seg_shift[:, a])
            seg_shift = np.where(same[:, None], seg_shift, 0)
            seg_of = np.minimum((col * nseg)
                                // np.maximum(len_n[:, None], 1),
                                nseg - 1)
            cell_shift = np.take_along_axis(seg_shift, seg_of, axis=1)
            pidx = col + cell_shift
            inb = (pidx >= 0) & (pidx < prev_len[:, None])
            prev_rows = np.roll(codes_s, 1, axis=0)
            aligned = np.take_along_axis(prev_rows,
                                         np.clip(pidx, 0, L - 1), axis=1)
            valid = col < len_n[:, None]
            match = (same[:, None] & inb & (aligned == codes_s) & valid)
            # density rule, per SEGMENT: random alignment of 2-bit
            # codes matches 25% of cells; segments below a 50% match
            # rate cost more mask than they save in literals — their
            # cells degrade to pure literals and their shift zeroes
            # (compressible planes), so indel-dense regions fall back
            # gracefully while re-locked segments keep their win
            for s in range(nseg):
                in_seg = seg_of == s
                seg_cells = (in_seg & valid).sum(axis=1)
                seg_match = (match & in_seg).sum(axis=1)
                kill = seg_match * 2 < seg_cells
                match &= ~(kill[:, None] & in_seg)
                seg_shift[kill, s] = 0
        valid = col < len_n[:, None]
        lits = codes_s[(~match) & valid]
        perm_np = np.concatenate([order_n,
                                  np.arange(n, B, dtype=np.int64)])
        len_s = np.zeros(B, np.int32)
        len_s[:n] = len_n
        delta_np = {
            "mask_bits": np.packbits(match, axis=1, bitorder="little"),
            "shifts": seg_shift.astype(np.int32),  # v7 [n, nseg] wide
            "nseg": nseg,
            "pred_k": np.zeros(n, np.uint8),
            "rc_bits": np.zeros((B + 7) // 8, np.uint8),
            "lits": lits, "n_lits": len(lits),
        }
        return self._assemble(block, perm_np, delta_np, len_s, None,
                              None, None)

    def encode_block(self, block: ReadBlock) -> EncodedBlock:
        return self.assemble(block, self.encode_device(block))

    def encode_device_pair(self, b1: ReadBlock, b2: ReadBlock,
                           pre1=None, pre2=None):
        cfg = self.cfg
        if self.long_mode:
            return ("long",), ("long",)
        if self.host_core:
            return ("hc",), ("hc",)
        out1 = self.encode_device(b1, pre=pre1)
        if pre2 is None:
            pre2 = self.upload(b2)
        uni2 = block_is_uniform(b2)
        if self.host_delta:
            perm = out1[2]
            buf2 = _device_stage_a2_hd(
                pre2["seq"], pre2["len"], pre2["exc"],
                perm.astype(jnp.int32), self.rank_lut,
                cfg.core_k, cfg.dict_seed, uniform=uni2)
            try:
                buf2.copy_to_host_async()
            except (AttributeError, NotImplementedError):
                pass
            return out1, ("hd", buf2)
        perm = out1[0]
        if not cfg.qual_on_device:
            codes_s, len2, ck_s, cp_s, rc_s = _device_stage_a2_nq(
                pre2["seq"], pre2["len"], pre2["exc"],
                perm.astype(jnp.int32), self.rank_lut,
                cfg.core_k, cfg.dict_seed, uniform=uni2)
            delta2 = _device_stage_b_nq(codes_s, len2, ck_s, cp_s, rc_s,
                                        jnp.int32(b2.n_reads))
            return out1, (delta2, len2, None, None, None)
        codes_s, qual_s, len2, ck_s, cp_s, rc_s = _device_stage_a2(
            pre2["seq"], pre2["qual"], pre2["len"], pre2["exc"],
            perm.astype(jnp.int32), self.rank_lut,
            cfg.core_k, cfg.dict_seed, uniform=uni2)
        delta2, sym2, ctx2, counts2 = _device_stage_b(
            codes_s, qual_s, len2, ck_s, cp_s, rc_s,
            jnp.int32(b2.n_reads), self.qual_map, cfg.qual_context_order)
        out2 = (delta2, len2, sym2, ctx2, counts2)
        return out1, out2

    def assemble_pair(self, b1: ReadBlock, b2: ReadBlock, devout
                      ) -> Tuple[EncodedBlock, EncodedBlock]:
        out1, out2 = devout
        if isinstance(out1[0], str) and out1[0] == "long":
            # mate 1 defines the minimizer order; mate 2 follows it for
            # pair sync (anchoring with its own minimizers inside)
            order1 = self._long_order(b1)
            eb1 = self._assemble_long(b1, order_n=order1)
            eb2 = self._assemble_long(b2, order_n=order1)
            return eb1, eb2
        if isinstance(out1[0], str) and out1[0] == "hc":
            from scalce_tpu import native
            n = b1.n_reads
            cores1 = native.core_match_block(
                b1.seq, b1.lengths, b1.exc_pos, n, self.cfg.core_k,
                self.cfg.dict_seed)
            eb1 = self._assemble_hc(b1, cores=cores1)
            perm_np = np.concatenate(
                [cores1[3], np.arange(n, b1.seq.shape[0],
                                      dtype=np.int64)])
            eb2 = self._assemble_hc(b2, perm_np=perm_np, mate2=True)
            return eb1, eb2
        if isinstance(out1[0], str):       # "hd" marker
            buf1 = np.asarray(out1[1])     # materialize ONCE (D2H)
            eb1 = self._assemble_hd(b1, buf1)
            # mate 2 reuses mate 1's permutation (already applied on
            # device); its buffer carries no perm copy
            perm_np = buf1[: b1.seq.shape[0]].astype(np.int64)
            eb2 = self._assemble_hd(b2, out2[1], with_perm=False,
                                    perm_np=perm_np)
            return eb1, eb2
        perm_np = np.asarray(out1[0])
        eb1 = self._assemble(b1, perm_np, *out1[1:])
        eb2 = self._assemble(b2, perm_np, *out2)
        return eb1, eb2

    def encode_block_pair(self, b1: ReadBlock, b2: ReadBlock
                          ) -> Tuple[EncodedBlock, EncodedBlock]:
        """Paired-end: mate 1 defines the permutation, mate 2 follows."""
        return self.assemble_pair(b1, b2, self.encode_device_pair(b1, b2))

    def _assemble(self, block: ReadBlock, perm_np: np.ndarray, delta,
                  len_s, sym, ctx, counts, enc_q=None) -> EncodedBlock:
        cfg = self.cfg
        B, L = block.seq.shape
        if enc_q is None and sym is None:
            # host-placement quality stream: the sort permutation and
            # the (lossy) remap LUT ride into the bit-identical native
            # codec, which fuses both into its own row walk (qualities
            # never crossed the device link, and the permuted grid is
            # never materialized)
            enc_q = qualities.encode_host(block.qual, np.asarray(len_s),
                                          cfg.qual_context_order,
                                          T_target=cfg.qual_T_target,
                                          qual_map=self.qual_map_np,
                                          perm=perm_np)
        elif enc_q is None:
            # quality stream pass B (device tables + rANS)
            enc_q = qualities.encode_from_grids(sym, ctx, counts, B, L,
                                                cfg.qual_context_order,
                                                T_target=cfg.qual_T_target)
        q_payload = qualities.payload(enc_q, backend=cfg.backend)

        # exceptions into the reordered frame (host; exceptions are rare)
        inv = np.empty(B, np.int64)
        inv[perm_np] = np.arange(B)
        if block.exc_pos.size:
            rows, cols = block.exc_pos // L, block.exc_pos % L
            new_pos = inv[rows] * L + cols
            order_idx = np.argsort(new_pos, kind="stable")
            exc_pos_s = new_pos[order_idx]
            exc_byte_s = block.exc_byte[order_idx]
        else:
            exc_pos_s = block.exc_pos
            exc_byte_s = block.exc_byte

        if "lits" in delta:
            delta_np = delta       # host-delta path: already NumPy
        else:
            # download the delta arrays; literals sliced to a pow2 bucket
            # on device first (same D2H-thrift pattern as the rANS words)
            n_lits = int(delta["n_lits"])
            n_words = (n_lits + 15) // 16
            # same bucket-floor rationale as qualities.finish_encoded
            W = max(64, (B * L // 16) // 16)
            while W < n_words:
                W <<= 1
            delta_np = {
                "mask_bits": np.asarray(delta["mask_bits"]),
                "shifts": np.asarray(delta["shifts"]),
                "lit_packed": np.asarray(_slice_flat(
                    delta["lit_packed"],
                    min(W, delta["lit_packed"].shape[0]))
                )[:n_words],
                "n_lits": n_lits,
                "pred_k": np.asarray(delta["pred_k"]),
                "rc_bits": np.asarray(delta["rc_bits"]),
            }
        r_payload = seqs.payload(delta_np, np.asarray(len_s),
                                 block.n_reads, exc_pos_s, exc_byte_s,
                                 perm_np, backend=cfg.backend)

        # names stay in ORIGINAL order (numeric deltas are tiny there);
        # the stored permutation re-aligns them with reads at decode time
        n_payload = self._encode_names(block)

        return EncodedBlock(block.block_id, block.n_reads, {
            "n": n_payload, "r": r_payload, "q": q_payload})

    def _encode_names(self, block: ReadBlock) -> bytes:
        from scalce_tpu import container
        n = block.n_reads
        arrays = {"n": np.asarray([n], np.int64)}
        deflate = []
        if self.cfg.name_lib is not None:
            # template mode (-n): names discarded; decoder regenerates
            arrays["template"] = np.asarray([1], np.uint8)
        else:
            blob = names_stream.encode(block.names, n,
                                       backend=self.cfg.backend)
            arrays["names_blob"] = np.frombuffer(blob, np.uint8)
        if block.plus is not None:
            arrays["plus_cat"] = block.plus.cat
            arrays["plus_lens"] = block.plus.lens.astype(np.uint32)
            deflate += ["plus_cat", "plus_lens"]
        return container.pack_arrays(arrays, deflate=deflate,
                                     backend=self.cfg.backend)


def warm_slice_variants(cfg: Config) -> None:
    """Pre-compile every pow2 slice-width variant the pipeline can hit
    (word and literal buckets).  Called once after the warm-up block so
    a timed phase never compiles for a block whose payload crossed a
    bucket boundary."""
    from scalce_tpu.config import resolve_read_len
    cfg = resolve_read_len(cfg)     # max_read_len=0 (AUTO) -> width
    if BlockEncoder(cfg).host_core:
        return          # host placement: no device jits exist to warm
    B, L = cfg.block_reads, cfg.max_read_len
    if cfg.qual_on_device:
        T = qualities.pick_T(B, L, cfg.qual_T_target)
        N = B * L // T
        words_dummy = jnp.zeros((N, T), jnp.uint16)
        W = max(64, T // 8)
        while W <= T:
            jax.block_until_ready(qualities._slice_words(words_dummy,
                                                         min(W, T)))
            W <<= 1
    lit_dummy = jnp.zeros(B * L // 16, jnp.uint32)
    W = max(64, (B * L // 16) // 16)
    while W <= B * L // 16:
        jax.block_until_ready(_slice_flat(lit_dummy,
                                          min(W, B * L // 16)))
        W <<= 1


def file_meta(cfg: Config) -> Dict:
    """Per-file metadata shared by every block (static pipeline shape)."""
    return {
        "block_reads": cfg.block_reads,
        "max_read_len": cfg.max_read_len,
        "core_k": cfg.core_k,
        "dict_seed": cfg.dict_seed,
        "qual_order": cfg.qual_context_order,
        "lossy_pct": cfg.lossy_pct,
        "name_lib": cfg.name_lib,
        "paired": cfg.paired,
    }
