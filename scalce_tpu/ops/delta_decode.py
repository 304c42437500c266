"""Device-parallel predecessor-delta reconstruction (decode side).

The encoder's copy mask is row-sequential by construction: row i copies
masked cells from row ``i-1-pred_k[i]`` at column ``col+shifts[i]``
(FORMAT.md ``.scalcer``), so the host decoders walk rows in order
[REF: scalce decompress.c record loop — UNVERIFIED; SURVEY.md §4.2].
On device that serial walk is replaced by pointer doubling over
per-CELL provenance (the ACEAPEX-style parallel chain collapse,
PAPERS.md): every copy cell points at its source cell, every literal /
padding cell points at itself, and ``ceil(log2(B))`` rounds of
``p = p[p]`` collapse each chain to its terminal cell — O(B·L·log B)
fully parallel work instead of a B-step serial loop.

Bit-exactness: reconstruction is pure integer provenance (no value
arithmetic), so the result is identical to the host loops by
construction; ``tests/test_roundtrip.py`` pins it.

SAFETY: the gathers here are unchecked (XLA clamps out-of-range
indices instead of faulting), so the caller MUST run the deep payload
validation first (``seqs._validate(deep=True)``) — the native host
path gets its bounds enforcement from the checked C loop instead.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32


def _ceil_log2(x: int) -> int:
    return max(1, (max(x, 1) - 1).bit_length())


@partial(jax.jit, static_argnames=("L", "steps"))
def _reconstruct_jit(mask_bits, shifts, pred_k, lits, lengths,
                     L: int, steps: int):
    """mask_bits u8 [B, L//8] (rows past n zero), shifts i32 [B],
    pred_k i32 [B], lits u8 [Npad] (pow2-padded), lengths i32 [B]
    -> codes u8 [B, L] (canonical orientation, padding cells zero)."""
    B = mask_bits.shape[0]
    col = jnp.arange(L, dtype=I32)
    # unpack LSB-first mask bits to a [B, L] copy grid
    bits = (mask_bits[:, col >> 3].astype(jnp.uint8)
            >> (col & 7).astype(jnp.uint8)) & 1
    valid = col[None, :] < lengths[:, None]
    is_copy = (bits == 1) & valid
    # literal cells take the next literal in row-major order — the
    # exact order the encoder emitted them (streams/seqs.py)
    lit_cell = (valid & ~is_copy).reshape(-1)
    lit_idx = jnp.cumsum(lit_cell.astype(I32)) - 1
    val0 = jnp.where(lit_cell,
                     lits[jnp.clip(lit_idx, 0, lits.shape[0] - 1)],
                     jnp.uint8(0))
    row = jnp.arange(B, dtype=I32)[:, None]
    self_i = row * L + col[None, :]
    src = (row - 1 - pred_k[:, None]) * L + (col[None, :]
                                             + shifts[:, None])
    ptr = jnp.where(is_copy, src, self_i).reshape(-1)
    # each hop strictly decreases the row, so chains are <= B long and
    # ceil(log2(B)) doubling rounds reach every terminal
    ptr = jax.lax.fori_loop(0, steps, lambda _, p: p[p], ptr)
    return val0[ptr].reshape(B, L)


def reconstruct_device(mask_bits: np.ndarray, shifts: np.ndarray,
                       pred_k: np.ndarray, lits: np.ndarray,
                       lens: np.ndarray, B: int, L: int,
                       out: np.ndarray) -> None:
    """Drop-in peer of ``seqs._reconstruct`` running on the default JAX
    device.  Pads every input to static shapes (B rows; literals to the
    next power of two) so block-to-block shape drift never recompiles.
    """
    n = len(lens)
    mb = np.zeros((B, L // 8), np.uint8)
    mb[:n] = mask_bits
    sh = np.zeros(B, np.int32)
    sh[:n] = shifts
    pk = np.zeros(B, np.int32)
    pk[:n] = pred_k
    lengths = np.zeros(B, np.int32)
    lengths[:n] = lens
    npad = max(16, 1 << int(lits.shape[0] - 1).bit_length()) \
        if lits.shape[0] else 16
    lp = np.zeros(npad, np.uint8)
    lp[: lits.shape[0]] = lits
    codes = _reconstruct_jit(jnp.asarray(mb), jnp.asarray(sh),
                             jnp.asarray(pk), jnp.asarray(lp),
                             jnp.asarray(lengths), L, _ceil_log2(B))
    out[:] = np.asarray(codes)
