"""Unit tests for the core matcher and reorder sort (CPU backend)."""

import jax.numpy as jnp
import numpy as np

from scalce_tpu.ops import bitops, core_match, reorder


def _np_kmer(codes_row, p, k):
    v = 0
    for i in range(k):
        v = (v << 2) | int(codes_row[p + i])
    return v


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(8, 64), dtype=np.uint8)
    packed = bitops.pack_bases_u32(jnp.asarray(codes), axis=1)
    assert packed.shape == (8, 4)
    out = bitops.unpack_bases_u32(packed, axis=1)
    np.testing.assert_array_equal(np.asarray(out), codes)


def test_pack_order_is_lexicographic():
    # 'AAAC' < 'AAAG' as strings must imply packed u32 <
    a = jnp.asarray(np.array([[0, 0, 0, 1] + [0] * 12], dtype=np.uint8))
    b = jnp.asarray(np.array([[0, 0, 0, 2] + [0] * 12], dtype=np.uint8))
    pa = int(bitops.pack_bases_u32(a, axis=1)[0, 0])
    pb = int(bitops.pack_bases_u32(b, axis=1)[0, 0])
    assert pa < pb


def test_rolling_kmers_match_reference_loop():
    rng = np.random.default_rng(1)
    k = 8
    codes = rng.integers(0, 4, size=(4, 40), dtype=np.uint8)
    got = np.asarray(core_match.rolling_kmers(jnp.asarray(codes), k))
    for b in range(4):
        for p in range(40 - k + 1):
            assert got[b, p] == _np_kmer(codes[b], p, k)


def test_find_cores_deterministic_and_masked():
    rng = np.random.default_rng(2)
    k, B, L = 8, 32, 50
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    lengths = np.full(B, L, dtype=np.int32)
    lengths[3] = k - 1          # too short -> NO_CORE
    exc = np.zeros((B, L), dtype=bool)
    exc[5, :] = True            # fully-N read -> NO_CORE
    exc[7, 10] = True           # one N: windows covering pos 10 invalid

    ck, cp = core_match.find_cores(jnp.asarray(codes), jnp.asarray(lengths),
                                   jnp.asarray(exc), k, seed=42)
    ck, cp = np.asarray(ck), np.asarray(cp)
    assert ck[3] == np.uint32(core_match.NO_CORE)
    assert ck[5] == np.uint32(core_match.NO_CORE)
    # numpy reference for a normal read (mix32 evaluated in one batch)
    for b in (0, 1, 7):
        P = lengths[b] - k + 1
        kms = np.array([_np_kmer(codes[b], p, k) for p in range(P)],
                       dtype=np.uint32)
        mixed = np.asarray(bitops.mix32(jnp.asarray(kms), 42)).astype(np.int64)
        for p in range(P):
            if exc[b, p:p + k].any():
                mixed[p] = 1 << 40
        best = int(np.argmin(mixed))
        assert cp[b] == best
        assert ck[b] == _np_kmer(codes[b], best, k)
    # determinism
    ck2, cp2 = core_match.find_cores(jnp.asarray(codes), jnp.asarray(lengths),
                                     jnp.asarray(exc), k, seed=42)
    np.testing.assert_array_equal(ck, np.asarray(ck2))


def test_find_cores_shared_core_same_bucket():
    # two reads sampled from the same genome region share their minimizer
    rng = np.random.default_rng(3)
    k = 12
    genome = rng.integers(0, 4, size=300, dtype=np.uint8)
    r1 = genome[50:150]
    r2 = genome[60:160]   # 90bp overlap
    codes = np.stack([r1, r2])
    lengths = np.full(2, 100, np.int32)
    exc = np.zeros((2, 100), bool)
    ck, cp = core_match.find_cores(jnp.asarray(codes), jnp.asarray(lengths),
                                   jnp.asarray(exc), k, seed=0)
    ck, cp = np.asarray(ck), np.asarray(cp)
    # minimizer of the union lies in the overlap with high probability for
    # this seed; assert bucket identity (regression-pinned)
    assert ck[0] == ck[1]
    assert cp[0] - cp[1] == 10  # same genome position


def test_sort_reorder_groups_and_pads_last():
    rng = np.random.default_rng(4)
    B, L, k = 64, 40, 8
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    lengths = np.full(B, L, np.int32)
    n_reads = 50
    exc = np.zeros((B, L), bool)
    ck, cp = core_match.find_cores(jnp.asarray(codes), jnp.asarray(lengths),
                                   jnp.asarray(exc), k, seed=0)
    keys = core_match.build_sort_keys(jnp.asarray(codes),
                                      jnp.asarray(lengths), ck, cp,
                                      jnp.int32(n_reads))
    perm = np.asarray(reorder.sort_permutation(keys))
    assert sorted(perm.tolist()) == list(range(B))
    # padding rows at the end
    assert set(perm[n_reads:].tolist()) == set(range(n_reads, B))
    # bucket keys are non-decreasing over the real prefix
    ck_np = np.asarray(ck)
    sorted_keys = ck_np[perm[:n_reads]]
    assert np.all(np.diff(sorted_keys.astype(np.int64)) >= 0)
    # inverse permutation restores arrival order
    inv = np.asarray(reorder.invert_permutation(jnp.asarray(perm)))
    np.testing.assert_array_equal(perm[inv], np.arange(B))


def test_explicit_rank_lut_mode():
    from scalce_tpu.models import core_dict
    k = 6
    lut = core_dict.build_rank_lut(k, seed=1)
    assert lut.shape == (4 ** k,)
    # homopolymers are maximally demoted
    polyA = 0
    polyT = int("3" * k, 4)
    assert lut[polyA] >= (3 << 28)
    assert lut[polyT] >= (3 << 28)
    # deterministic
    np.testing.assert_array_equal(lut, core_dict.build_rank_lut(k, seed=1))

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=(16, 40), dtype=np.uint8)
    lengths = np.full(16, 40, np.int32)
    exc = np.zeros((16, 40), bool)
    ck, cp = core_match.find_cores(jnp.asarray(codes), jnp.asarray(lengths),
                                   jnp.asarray(exc), k, seed=1,
                                   rank_lut=jnp.asarray(lut))
    ck, cp = np.asarray(ck), np.asarray(cp)
    # cores chosen = argmin of lut over valid windows
    for b in range(16):
        kms = np.array([_np_kmer(codes[b], p, k) for p in range(40 - k + 1)])
        best = int(np.argmin(np.asarray(lut)[kms]))
        assert cp[b] == best and ck[b] == kms[best]


def test_lut_mode_end_to_end(tmp_path):
    from scalce_tpu.config import Config
    from scalce_tpu.pipeline import driver
    from scalce_tpu.utils.synth import synth_fastq
    payload = synth_fastq(800, 96, seed=21)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=1 << 10,
                 dict_mode="lut", core_k=8)
    driver.compress(cfg)
    dcfg = Config(mode="decompress", inputs=(str(tmp_path / "o.00.scalcer"),),
                  output=str(tmp_path / "d"), block_reads=1 << 10,
                  keep_order=True)
    driver.decompress(dcfg)
    assert (tmp_path / "d.fastq").read_bytes() == payload


def test_uniform_orientation_path_bit_identical():
    """The static ``uniform`` fast path (flip + dynamic_slice instead of
    per-element gathers) must match the general path EXACTLY on blocks
    whose real reads share one length — including partial blocks whose
    padding rows have length 0."""
    rng = np.random.default_rng(7)
    B, L, k, seed, l = 64, 48, 8, 0x5CA1CE, 37
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    n_reads = 50                       # rows >= n_reads are padding
    lengths = np.zeros(B, np.int32)
    lengths[:n_reads] = l
    codes[n_reads:, :] = 0
    codes[:, l:] = 0
    exc = np.zeros((B, L), bool)
    exc[rng.integers(0, n_reads, 20), rng.integers(0, l, 20)] = True

    outs = {}
    for uni in (False, True):
        outs[uni] = core_match.find_cores_canonical(
            jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(exc),
            k, seed, uniform=uni)
    names = ("ck", "cp", "is_rc", "codes_o", "exc_o")
    for name, a, b in zip(names, outs[False], outs[True]):
        if name == "exc_o":
            # exc_o may differ on padding rows only (unused downstream —
            # every call site discards it); real rows must agree
            np.testing.assert_array_equal(np.asarray(a)[:n_reads],
                                          np.asarray(b)[:n_reads],
                                          err_msg=name)
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


def test_reverse_complement_uniform_matches_general():
    rng = np.random.default_rng(8)
    B, L, l = 32, 64, 53
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[:, l:] = 0
    lengths = np.full(B, l, np.int32)
    a = np.asarray(core_match.reverse_complement(
        jnp.asarray(codes), jnp.asarray(lengths)))
    b = np.asarray(core_match.reverse_complement_uniform(
        jnp.asarray(codes), jnp.asarray(lengths)[0]))
    np.testing.assert_array_equal(a, b)


def test_core_reductions_match_numpy_per_row():
    """The matcher's six per-row reductions (best rank, first arg and
    k-mer per strand; the RC strand breaks ties on the LAST forward
    position) and the selects after them, against a per-row NumPy
    loop, on ragged rows, exception windows and all-invalid rows."""
    rng = np.random.default_rng(12)
    B, L, k, seed = 64, 48, 8, 0x5CA1CE
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    lengths = rng.integers(k, L + 1, size=B).astype(np.int32)
    lengths[:4] = 0                       # all-invalid rows
    col = np.arange(L)[None, :]
    codes = np.where(col < lengths[:, None], codes, 0).astype(np.uint8)
    exc = np.zeros((B, L), bool)
    exc[rng.integers(4, B, 30), rng.integers(0, L, 30)] = True
    ck, cp, is_rc, _, _ = [np.asarray(x) for x in
                           core_match.find_cores_canonical(
                               jnp.asarray(codes), jnp.asarray(lengths),
                               jnp.asarray(exc), k, seed)]
    P = L - k + 1
    km = np.zeros((B, P), np.uint32)
    rkm = np.zeros((B, P), np.uint32)
    for r in range(B):
        for p in range(P):
            km[r, p] = _np_kmer(codes[r], p, k)
            rkm[r, p] = _np_kmer(3 - codes[r, p:p + k][::-1], 0, k)
    rank_f = np.asarray(bitops.mix32(jnp.asarray(km), seed))
    rank_r = np.asarray(bitops.mix32(jnp.asarray(rkm), seed))
    MAX = 0xFFFFFFFF
    for r in range(B):
        ln = int(lengths[r])
        ok = [p for p in range(max(0, ln - k + 1))
              if not exc[r, p:p + k].any()]
        want = (MAX, 0, False)               # (core k-mer, pos, rc)
        if ok:
            pf = min(ok, key=lambda p: (int(rank_f[r, p]), p))
            pfw = min(ok, key=lambda p: (int(rank_r[r, p]), -p))
            if rank_r[r, pfw] < rank_f[r, pf]:
                want = (int(rkm[r, pfw]), ln - k - pfw, True)
            else:
                want = (int(km[r, pf]), pf, False)
        assert (int(ck[r]), int(cp[r]), bool(is_rc[r])) == want, r
