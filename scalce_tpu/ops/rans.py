"""Vectorized interleaved rANS — the device replacement for the
reference's adaptive arithmetic coder.

The reference encodes quality symbols one at a time through an adaptive
order-k arithmetic coder [REF: scalce arithmetic.c encode_symbol —
UNVERIFIED; SURVEY.md §2 "Quality codec"].  Bit-serial adaptive AC is
unvectorizable (every symbol mutates the model).  The device design is
**two-pass static-table rANS over thousands of independent lanes**
(SURVEY.md §8 step 2):

  pass A  device histogram of (context, symbol) pairs
  host    deterministic normalization of counts -> static tables
  pass B  device ``lax.scan`` over time steps; every step encodes one
          symbol in EVERY lane simultaneously

Layout: a block's S symbols are split into ``N = S // T`` lanes, lane n
owning the contiguous span ``[n*T, (n+1)*T)`` (lane-major).  Spans are
aligned to read boundaries by the caller so order-k contexts never cross
a lane, which is what lets decode recompute contexts from its own
previous output inside the scan.

Coder constants (fixed across the framework):

  state     uint32 in [2^16, 2^32)
  renorm    16-bit words, at most ONE per symbol because a symbol costs
            at most PROB_BITS = 12 < 16 bits
  PROB_BITS 12  (total frequency M = 4096)

The inner division ``x // f`` (f <= 4096) is computed exactly via two
f32 divisions on <2^24 operands plus an integer correction step (see
``udiv_u32_small``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from scalce_tpu.ops.bitops import U32

PROB_BITS = 12
M_TOTAL = 1 << PROB_BITS
# np scalars, NOT jnp: module-level jnp calls initialize the device
# backend at import time; numpy scalars trace identically (strong
# uint32)
RANS_L = np.uint32(1 << 16)           # state lower bound
_MASK16 = np.uint32(0xFFFF)
_MASK12 = np.uint32(M_TOTAL - 1)

I32 = jnp.int32
F32 = jnp.float32


def _f32_floordiv(a: jnp.ndarray, f: jnp.ndarray) -> jnp.ndarray:
    """Exact floor(a / f) for 0 <= a < 2^24, 1 <= f <= 2^13 (uint32 in/out).

    a and f are exactly representable in f32; the f32 quotient is within
    1 of the true floor, fixed by one integer correction.
    """
    q = jnp.floor(a.astype(F32) / f.astype(F32)).astype(I32)
    r = a.astype(I32) - q * f.astype(I32)
    fi = f.astype(I32)
    q = jnp.where(r < 0, q - 1, jnp.where(r >= fi, q + 1, q))
    return q.astype(U32)


def udiv_u32_small(x: jnp.ndarray, f: jnp.ndarray
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact (x // f, x % f) for uint32 x and 1 <= f <= 4096.

    Splits x = xh·2^12 + xl; both partial dividends stay below 2^24 so
    each f32 division is exactly correctable.
    """
    xh = x >> 12                       # < 2^20
    xl = x & _MASK12                   # < 2^12
    q1 = _f32_floordiv(xh, f)
    rem1 = xh - q1 * f                 # < f <= 2^12
    low = (rem1 << 12) | xl            # < 2^24
    q2 = _f32_floordiv(low, f)
    r = low - q2 * f
    return (q1 << 12) + q2, r


def rans_encode(sym: jnp.ndarray, ctx: jnp.ndarray,
                freq_lut: jnp.ndarray, cum_lut: jnp.ndarray,
                n_syms: int, T: int
                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Encode ``S = N*T`` symbols in N interleaved lanes.

    sym, ctx: uint32 ``[S]`` flat, lane-major (lane n owns span n*T..).
    freq_lut, cum_lut: uint32 ``[C * n_syms]`` static tables (row = ctx).
    Returns ``(states u32 [N], words u16 [T, N], emits bool [T, N])``
    with the time axis in DECODE order: the word (if any) at step t is
    the one the decoder consumes right after decoding symbol t.
    """
    S = sym.shape[0]
    N = S // T
    # hoist the table lookups OUT of the scan: (ctx, sym) is fully known
    # ahead of encode, so one S-element gather replaces T in-scan gathers
    idx = ctx * U32(n_syms) + sym
    f_all = freq_lut[idx].reshape(N, T).T      # [T, N]
    c_all = cum_lut[idx].reshape(N, T).T

    def step(x, args):
        f, cum = args
        # renorm before encode: emit low 16 bits while x >= f << 20;
        # compared as (x >> 20) >= f because f << 20 overflows u32 at
        # f = M_TOTAL (a full-mass context, e.g. padding)
        emit = (x >> 20) >= f
        word = (x & _MASK16).astype(jnp.uint16)
        x = jnp.where(emit, x >> 16, x)
        q, r = udiv_u32_small(x, f)
        x = (q << PROB_BITS) + r + cum
        return x, (word, emit)

    # derive the carry from an input so its sharding "varying" axes match
    # the scanned operands under shard_map (zero-cost after fusion)
    x0 = (f_all[0] & U32(0)) + RANS_L
    # encoder walks t = T-1 .. 0 (reverse data order)
    xs = (f_all[::-1], c_all[::-1])
    x_fin, (words, emits) = jax.lax.scan(step, x0, xs, unroll=2)
    return x_fin, words[::-1], emits[::-1]


def compact_emissions(words: jnp.ndarray, emits: jnp.ndarray
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-lane stream compaction of ``[T, N]`` emissions.

    Returns ``(packed u16 [N, T], counts i32 [N])``: lane n's words in
    decode order at ``packed[n, :counts[n]]``, zeros beyond.  Done as a
    minor-axis key-value sort (emitted slots keyed by their compacted
    position, the rest by T) instead of a 1-D scatter; byte-identical
    including the zeroed tail.
    """
    T, N = words.shape
    wt = words.T.astype(jnp.uint32)                      # [N, T]
    et = emits.T
    pos = jnp.cumsum(et.astype(I32), axis=1) - 1
    key = jnp.where(et, pos, T).astype(jnp.uint32)
    # ONE u32 carries key<<16 | word (key <= T <= 2^15, word is u16):
    # a single-operand sort runs ~2x the key-value form.  Emitted slots
    # have unique keys so their order is exact; trash slots (shared key
    # T) order by word value among themselves and are zeroed below.
    sval = jnp.sort((key << 16) | wt, axis=1)
    counts = jnp.sum(et.astype(I32), axis=1)
    col = jnp.arange(T, dtype=I32)[None, :]
    packed = jnp.where(col < counts[:, None], sval & jnp.uint32(0xFFFF),
                       0).astype(jnp.uint16)
    return packed, counts


def rans_decode(states: jnp.ndarray, words_padded: jnp.ndarray,
                decode_lut: jnp.ndarray,
                ctx_fn: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
                aux: jnp.ndarray, T: int) -> jnp.ndarray:
    """Decode T symbols per lane.

    states: uint32 ``[N]`` final encoder states.
    words_padded: uint16 ``[N, W]`` per-lane streams in decode order.
    decode_lut: uint32 ``[C * M_TOTAL]`` packed rows: for ctx c and slot
      s, ``decode_lut[c*M + s] = sym<<24 | (freq-1)<<12 | cum``.
    ctx_fn(aux_t, prev1, prev2) -> uint32 ctx per lane; ``aux`` is a
      pytree with leading axis T (model-specific position info, sliced
      per step).  prev1/prev2 are the last two decoded symbols in the
      lane (0 before the span starts) — enough for order-2 models.
    Returns sym uint32 ``[T, N]`` (time-major; reshape to lanes outside).
    """
    N = states.shape[0]

    def step(carry, aux_t):
        x, cursor, prev1, prev2 = carry
        c = ctx_fn(aux_t, prev1, prev2).astype(U32)
        slot = x & _MASK12
        e = decode_lut[c * U32(M_TOTAL) + slot]
        s = e >> 24
        f = ((e >> 12) & _MASK12) + U32(1)
        cum = e & _MASK12
        x = f * (x >> PROB_BITS) + slot - cum
        # renorm: pull one 16-bit word if below lower bound
        need = x < RANS_L
        w = words_padded[jnp.arange(N, dtype=I32),
                         jnp.minimum(cursor, words_padded.shape[1] - 1)]
        x = jnp.where(need, (x << 16) | w.astype(U32), x)
        cursor = cursor + need.astype(I32)
        return (x, cursor, s, prev1), s

    zero_u = states & U32(0)            # varying-axes-matched zeros
    carry0 = (states, zero_u.astype(I32), zero_u, zero_u)
    (x_end, _, _, _), syms = jax.lax.scan(step, carry0, aux)
    # invariant: fully-drained lanes return to the lower bound
    del x_end
    return syms


def context_histogram(sym: jnp.ndarray, ctx: jnp.ndarray,
                      n_ctx: int, n_syms: int) -> jnp.ndarray:
    """Device histogram of (ctx, sym) pairs -> i32 [n_ctx*n_syms].

    Integer scatter-adds commute, so the counts (and every table built
    from them) are exact whatever order the device applies them in."""
    idx = (ctx * U32(n_syms) + sym).astype(I32)
    return jnp.zeros(n_ctx * n_syms, dtype=I32).at[idx].add(1)
