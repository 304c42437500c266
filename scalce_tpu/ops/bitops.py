"""Shared integer/bit utilities for device ops (uint32 domain)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
#: Sentinel rank for invalid core positions / empty rows: sorts last.
#: np scalar, NOT jnp: a module-level jnp call would initialize the
#: device backend at IMPORT time (tests/test_import_hygiene.py).  Under
#: tracing both are strong uint32 scalars (identical promotion).
U32_MAX = np.uint32(0xFFFFFFFF)


def mix32(x: jnp.ndarray, seed: int) -> jnp.ndarray:
    """murmur3-style 32-bit finalizer; a fixed pseudo-random ranking of ints.

    Used to rank k-mers: the k-mer with the minimal mixed value inside a
    read is its "core".  This replaces the reference's shipped LCP
    core-priority table [REF: scalce reads.c pattern init — UNVERIFIED;
    SURVEY.md §2 "LCE core dictionary"] with an implicit dictionary: a
    deterministic, uniformly-spread priority over all k-mers (the
    minimizer scheme), which needs no table broadcast at all and is
    identical on every host/device by construction (SURVEY.md §8 hard
    part: deterministic multi-host ordering).
    """
    x = x.astype(U32) ^ U32(seed & 0xFFFFFFFF)
    x = x ^ (x >> 16)
    x = x * U32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * U32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def pack_bases_u32(codes: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Pack groups of 16 2-bit base codes into big-endian uint32 words.

    Big-endian within the word (first base in the highest bits) so that
    unsigned integer comparison of packed words equals lexicographic
    comparison of the underlying base strings — the property the
    reorder sort keys rely on.
    The size of ``codes`` along ``axis`` must be a multiple of 16.
    """
    codes = jnp.moveaxis(codes, axis, -1)
    *lead, n = codes.shape
    grouped = codes.reshape(*lead, n // 16, 16).astype(U32)
    shifts = (U32(2) * jnp.arange(15, -1, -1, dtype=U32))
    packed = jnp.sum(grouped << shifts, axis=-1, dtype=U32)
    return jnp.moveaxis(packed, -1, axis)


def unpack_bases_u32(packed: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Inverse of :func:`pack_bases_u32` (uint32 words -> 2-bit codes)."""
    packed = jnp.moveaxis(packed, axis, -1)
    shifts = (U32(2) * jnp.arange(15, -1, -1, dtype=U32))
    codes = (packed[..., None] >> shifts) & U32(3)
    *lead, n, _ = codes.shape
    out = codes.reshape(*lead, n * 16).astype(jnp.uint8)
    return jnp.moveaxis(out, -1, axis)


def rev_lanes_u32(v: jnp.ndarray) -> jnp.ndarray:
    """Reverse the 16 2-bit lanes of each u32 word (big<->little lane
    order; an involution).  Shared by the reverse-complement k-mer
    helpers and the literal-compaction bit network."""
    v = ((v & U32(0x33333333)) << 2) | ((v >> 2) & U32(0x33333333))
    v = ((v & U32(0x0F0F0F0F)) << 4) | ((v >> 4) & U32(0x0F0F0F0F))
    v = ((v & U32(0x00FF00FF)) << 8) | ((v >> 8) & U32(0x00FF00FF))
    return (v << 16) | (v >> 16)
