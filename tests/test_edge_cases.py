"""Edge-case round-trips: empty input, single read, tiny reads, all-N,
extreme quality bytes, unstructured names (raw fallback)."""

import numpy as np
import pytest

from scalce_tpu.config import Config
from scalce_tpu.pipeline import driver


def _roundtrip_bytes(tmp_path, payload: bytes, **kw):
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=256, **kw)
    driver.compress(cfg)
    dcfg = Config(mode="decompress", inputs=(str(tmp_path / "o.00.scalcer"),),
                  output=str(tmp_path / "d"), block_reads=256,
                  keep_order=True)
    driver.decompress(dcfg)
    return (tmp_path / "d.fastq").read_bytes()


def test_empty_input(tmp_path):
    assert _roundtrip_bytes(tmp_path, b"") == b""


def test_single_read(tmp_path):
    payload = b"@only\nACGTACGTACGT\n+\nIIIIIIIIIIII\n"
    assert _roundtrip_bytes(tmp_path, payload) == payload


def test_reads_shorter_than_core_k(tmp_path):
    payload = b"".join(
        f"@r{i}\nACG\n+\nIII\n".encode() for i in range(10))
    assert _roundtrip_bytes(tmp_path, payload) == payload


def test_all_n_reads(tmp_path):
    payload = b"".join(
        f"@n{i}\n{'N'*50}\n+\n{'#'*50}\n".encode() for i in range(20))
    assert _roundtrip_bytes(tmp_path, payload) == payload


def test_lowercase_and_iupac_bases(tmp_path):
    payload = (b"@x\nacgtRYKMswBDHVn\n+\nIIIIIIIIIIIIIII\n"
               b"@y\nACGTacgtNNRRYYKK\n+\nIIIIIIIIIIIIIIII\n")
    assert _roundtrip_bytes(tmp_path, payload) == payload


def test_extreme_quality_bytes(tmp_path):
    # full printable FASTQ quality range '!' (33) .. '~' (126)
    quals = bytes(range(33, 127))
    seq = b"A" * len(quals)
    payload = b"@q\n" + seq + b"\n+\n" + quals + b"\n"
    assert _roundtrip_bytes(tmp_path, payload) == payload


def test_unstructured_names_fallback(tmp_path):
    names = [b"weird [name] {with} ~stuff~ 1",
             b"@@@", b"x", b"tab\ttab", b"trailing ", b"",
             b"unicode-\xc3\xa9\xc2\xb5"]
    recs = []
    for i, nm in enumerate(names):
        recs.append(b"@" + nm + b"\nACGTACGT\n+\nIIIIIIII\n")
    payload = b"".join(recs)
    assert _roundtrip_bytes(tmp_path, payload) == payload


def test_plus_line_with_repeated_name(tmp_path):
    payload = (b"@r1 desc\nACGT\n+r1 desc\nIIII\n"
               b"@r2\nGGCC\n+r2\nJJJJ\n")
    assert _roundtrip_bytes(tmp_path, payload) == payload


def test_mixed_read_lengths_same_block(tmp_path):
    rng = np.random.default_rng(0)
    recs = []
    for i in range(64):
        L = int(rng.integers(1, 128))
        seq = bytes(rng.choice(list(b"ACGT"), L).astype(np.uint8))
        q = bytes(rng.integers(33, 127, L).astype(np.uint8))
        recs.append(b"@m" + str(i).encode() + b"\n" + seq + b"\n+\n" + q
                    + b"\n")
    payload = b"".join(recs)
    assert _roundtrip_bytes(tmp_path, payload) == payload


def test_corrupt_scalcer_fields_rejected(tmp_path):
    """A bit-flipped .scalcer block must raise, never feed the native
    reconstruction loop out-of-bounds values (code-review finding)."""
    from scalce_tpu import container
    from scalce_tpu.utils.synth import synth_fastq
    payload = synth_fastq(500, 80, seed=90)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=512)
    driver.compress(cfg)
    # rewrite the r-stream block with a hostile lengths array
    rp = str(tmp_path / "o.00.scalcer")
    rd = container.StreamReader(rp)
    blob = rd.read_block(rd.blocks[0])
    rd.close()
    a = container.unpack_arrays(blob)
    a = dict(a)
    bad = a["lengths"].copy()
    bad[0] = 65535
    a["lengths"] = bad
    evil = container.pack_arrays(a)
    w = container.StreamWriter(rp, "r", rd.meta)
    w.add_block(0, evil, 500)
    w.close()
    dcfg = Config(mode="decompress", inputs=(rp,),
                  output=str(tmp_path / "d"), block_reads=512)
    with pytest.raises(ValueError, match="corrupt"):
        driver.decompress(dcfg)


def test_quality_byte_out_of_range_rejected(tmp_path):
    payload = b"@r\nACGT\n+\n I~\x7f\n"       # space (32) + DEL (127)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=256)
    with pytest.raises(ValueError, match="quality byte"):
        driver.compress(cfg)


def test_paired_resume(tmp_path):
    from scalce_tpu.utils.synth import synth_pair
    a, b = synth_pair(3000, 100, seed=91)
    p1, p2 = tmp_path / "a.fastq", tmp_path / "b.fastq"
    p1.write_bytes(a)
    p2.write_bytes(b)
    base = dict(mode="compress", inputs=(str(p1), str(p2)), paired=True,
                block_reads=1 << 10, output=str(tmp_path / "o"))
    driver.compress(Config(**base))
    # tear the tail of BOTH mates symmetrically (same lost block)
    for m in (1, 2):
        for ext in (".scalcen", ".scalcer", ".scalceq"):
            p = tmp_path / f"o.00_{m}{ext}"
            p.write_bytes(p.read_bytes()[:-50])
    st = driver.compress(Config(resume=True, **base))
    assert 0 < st.n_blocks < 3
    dcfg = Config(mode="decompress", inputs=(str(tmp_path / "o.00_1.scalcen"),),
                  output=str(tmp_path / "d"), block_reads=1 << 10,
                  keep_order=True)
    driver.decompress(dcfg)
    assert (tmp_path / "d_1.fastq").read_bytes() == a
    assert (tmp_path / "d_2.fastq").read_bytes() == b


def test_paired_resume_asymmetric(tmp_path):
    """A crash can make a block durable in ONE mate only.  Resume must
    re-truncate BOTH mates to the intersection of their durable blocks
    (pair-sync invariant) and re-encode onward — including cutting into
    a completed, footered part."""
    from scalce_tpu.utils.synth import synth_pair
    a, b = synth_pair(3000, 100, seed=93)
    p1, p2 = tmp_path / "a.fastq", tmp_path / "b.fastq"
    p1.write_bytes(a)
    p2.write_bytes(b)
    base = dict(mode="compress", inputs=(str(p1), str(p2)), paired=True,
                block_reads=1 << 10, output=str(tmp_path / "o"))
    driver.compress(Config(**base))
    # tear ONLY mate 2 (mate 1 keeps its complete footered part)
    for ext in (".scalcen", ".scalcer", ".scalceq"):
        p = tmp_path / f"o.00_2{ext}"
        p.write_bytes(p.read_bytes()[:-50])
    st = driver.compress(Config(resume=True, **base))
    assert 0 < st.n_blocks < 3            # some blocks survived, some redone
    dcfg = Config(mode="decompress",
                  inputs=(str(tmp_path / "o.00_1.scalcen"),),
                  output=str(tmp_path / "d"), block_reads=1 << 10,
                  keep_order=True)
    driver.decompress(dcfg)
    assert (tmp_path / "d_1.fastq").read_bytes() == a
    assert (tmp_path / "d_2.fastq").read_bytes() == b


def test_paired_resume_asymmetric_parts(tmp_path):
    """Asymmetric resume across part boundaries: the cut can orphan a
    whole later part, which must be deleted, not left to confuse a
    future reader."""
    from scalce_tpu.utils.synth import synth_pair
    a, b = synth_pair(4000, 100, seed=94)
    p1, p2 = tmp_path / "a.fastq", tmp_path / "b.fastq"
    p1.write_bytes(a)
    p2.write_bytes(b)
    base = dict(mode="compress", inputs=(str(p1), str(p2)), paired=True,
                block_reads=1 << 10, part_size=100_000,
                output=str(tmp_path / "o"))
    driver.compress(Config(**base))
    parts1 = sorted(p.name for p in tmp_path.glob("o.*_1.scalcen"))
    assert len(parts1) >= 2, parts1
    # destroy mate 2 back to its FIRST part's first block: truncate every
    # later part away and tear part 0
    for p in tmp_path.glob("o.*_2.scalce?"):
        if not p.name.startswith("o.00"):
            p.unlink()
    for ext in (".scalcen", ".scalcer", ".scalceq"):
        p = tmp_path / f"o.00_2{ext}"
        p.write_bytes(p.read_bytes()[:-50])
    driver.compress(Config(resume=True, **base))
    dcfg = Config(mode="decompress",
                  inputs=(str(tmp_path / "o.00_1.scalcen"),),
                  output=str(tmp_path / "d"), block_reads=1 << 10,
                  keep_order=True)
    driver.decompress(dcfg)
    assert (tmp_path / "d_1.fastq").read_bytes() == a
    assert (tmp_path / "d_2.fastq").read_bytes() == b


def test_long_reads_512(tmp_path):
    """Longer-read platforms: 300-500bp reads under --max-read-len 512
    (in-read windows keep core matching local; SURVEY.md §6 long reads)."""
    from scalce_tpu.utils.synth import synth_fastq
    payload = synth_fastq(400, 500, seed=95, var_len=True,
                          genome_len=60_000, n_rate=0.002)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=512,
                 max_read_len=512)
    driver.compress(cfg)
    dcfg = Config(mode="decompress", inputs=(str(tmp_path / "o.00.scalcer"),),
                  output=str(tmp_path / "d"), block_reads=512,
                  max_read_len=512, keep_order=True)
    driver.decompress(dcfg)
    assert (tmp_path / "d.fastq").read_bytes() == payload


def test_corrupt_pred_k_self_reference_rejected(tmp_path):
    """pred_k[i] == i with mask bits set would read before the output
    buffer in the native loop — the validator must reject it."""
    from scalce_tpu import container
    from scalce_tpu.utils.synth import synth_fastq
    payload = synth_fastq(500, 80, seed=97, genome_len=5_000)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=512)
    driver.compress(cfg)
    rp = str(tmp_path / "o.00.scalcer")
    rd = container.StreamReader(rp)
    blob = rd.read_block(rd.blocks[0])
    rd.close()
    a = dict(container.unpack_arrays(blob))
    pk = a["pred_k"].copy()
    # force a self-referential predecessor on a row that has mask bits
    bits = np.unpackbits(a["mask_bits"], axis=1, bitorder="little")
    masked_rows = np.flatnonzero(bits.any(axis=1))
    assert masked_rows.size, "fixture needs at least one matching read"
    i = int(masked_rows[0])
    pk[i] = i
    a["pred_k"] = pk
    w = container.StreamWriter(rp, "r", rd.meta)
    w.add_block(0, container.pack_arrays(a), 500)
    w.close()
    dcfg = Config(mode="decompress", inputs=(rp,),
                  output=str(tmp_path / "d"), block_reads=512)
    with pytest.raises(ValueError, match="corrupt"):
        driver.decompress(dcfg)


def test_long_read_cli_config_accepted():
    # regression: long-read configs beyond qual_T_target must validate
    Config(mode="compress", inputs=("x.fastq",), max_read_len=2048)


def test_native_name_analysis_byte_identical():
    """The one-pass C name analyzer must produce EXACTLY the numpy
    path's payload bytes across const/numeric/raw mixes, leading
    zeros, >18-digit fields, empty fields, and separator-free names."""
    from scalce_tpu.io.fastq import Ragged
    from scalce_tpu.streams import names as ns
    from scalce_tpu import native
    if not (native.AVAILABLE and hasattr(native, "analyze_names")):
        import pytest
        pytest.skip("native analyze_names unavailable")

    cases = [
        [b"SRR001.1 len=100", b"SRR001.2 len=100", b"SRR001.3 len=96"],
        [b"a:0123:7", b"a:0456:8", b"a:0789:9"],          # leading zeros
        [b"x.99999999999999999999.1", b"x.2.2"],          # >18 digits
        [b"p__q", b"r__s"],                               # empty fields
        [b"plainname1", b"plainname2", b"plainname3"],    # k = 0
        [b"const const const", b"const const const"],     # all const
        [b"m/1", b"m/2", b"m/x"],                         # num->raw demote
        [b"a b", b"a-b"],                                 # pattern mismatch
        [b"", b""],                                       # empty names
    ]
    for recs in cases:
        r = Ragged.from_list(recs)
        native_blob = ns.encode(r, len(recs), backend="zstd")
        # force the numpy path by making the native hook unavailable
        orig = ns._encode_fields_native
        ns._encode_fields_native = lambda *a, **k: False
        try:
            numpy_blob = ns.encode(r, len(recs), backend="zstd")
        finally:
            ns._encode_fields_native = orig
        assert native_blob == numpy_blob, recs
        # and the payload decodes back to the records
        dec = ns.decode(native_blob)
        assert dec.to_list() == list(recs)


def test_heavy_exception_round_trip(tmp_path):
    """50% non-ACGT bases stress the vectorized translate's exception
    extraction (ctz loop) and the exception-buffer growth/retry."""
    import numpy as np

    from scalce_tpu.config import Config
    from scalce_tpu.pipeline import driver
    from scalce_tpu.utils.synth import synth_fastq

    payload = synth_fastq(800, 64, seed=5, n_rate=0.5, var_len=True)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=256,
                 max_read_len=128)
    driver.compress(cfg)
    dcfg = Config(mode="decompress",
                  inputs=(str(tmp_path / "o.00.scalcer"),),
                  output=str(tmp_path / "d"), block_reads=256,
                  keep_order=True)
    driver.decompress(dcfg)
    assert (tmp_path / "d.fastq").read_bytes() == payload


def test_tiny_read_lengths_round_trip(tmp_path):
    """Reads of length 1..4 exercise every scalar prologue / masked
    tail of the SIMD kernels (parse translate, hist, coders, delta)."""
    recs = []
    for i, seq in enumerate(["A", "AC", "ACG", "ACGT", "T", "GG",
                             "NNN", "ACGTACGT"] * 40):
        q = "I" * len(seq)
        recs.append(f"@r{i}\n{seq}\n+\n{q}\n")
    payload = "".join(recs).encode()
    from scalce_tpu.config import Config
    from scalce_tpu.pipeline import driver
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=256,
                 max_read_len=16)
    driver.compress(cfg)
    dcfg = Config(mode="decompress",
                  inputs=(str(tmp_path / "o.00.scalcer"),),
                  output=str(tmp_path / "d"), block_reads=256,
                  keep_order=True)
    driver.decompress(dcfg)
    assert (tmp_path / "d.fastq").read_bytes() == payload


def test_missing_input_fails_before_output(tmp_path):
    """A missing input must raise BEFORE any output triplet is created
    (a torn triplet used to be left behind, caught only at decode)."""
    import pytest
    from scalce_tpu.config import Config
    from scalce_tpu.pipeline import driver
    out = tmp_path / "out"
    cfg = Config(mode="compress", inputs=(str(tmp_path / "nope.fastq"),),
                 output=str(out))
    with pytest.raises(FileNotFoundError):
        driver.compress(cfg)
    assert not list(tmp_path.glob("out.*"))


def test_long_read_mode_roundtrip_100kbp(tmp_path):
    """Long-read mode (VERDICT r2 missing #4): 100 kbp reads must
    round-trip byte-exactly through the v5 container — u32 lengths,
    identity order, literal-only sequence stream, T = L qualities."""
    import numpy as np
    from scalce_tpu import container
    from scalce_tpu.config import Config
    from scalce_tpu.pipeline import driver

    rng = np.random.default_rng(12)
    L = 100_000
    reads = []
    for i in range(6):
        ln = int(rng.integers(L // 2, L + 1))
        seq = rng.choice(list(b"ACGTN"), size=ln,
                         p=[0.24, 0.24, 0.24, 0.24, 0.04]).astype(np.uint8)
        qv = np.clip(np.cumsum(rng.integers(-1, 2, size=ln)) + 20,
                     2, 50).astype(np.uint8) + 33
        reads.append(b"@read/%d\n%s\n+\n%s\n"
                     % (i, bytes(seq), qv.tobytes()))
    payload = b"".join(reads)
    inp = tmp_path / "long.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=256,
                 max_read_len=L, qual_context_order=1)
    driver.compress(cfg)
    # the container must be stamped with the current version
    r = container.StreamReader(str(tmp_path / "o.00.scalcer"))
    r.close()
    import struct
    with open(tmp_path / "o.00.scalcer", "rb") as f:
        f.seek(8)
        (ver,) = struct.unpack("<H", f.read(2))
    assert ver == container.VERSION == 7
    driver.decompress(Config(mode="decompress",
                             inputs=(str(tmp_path / "o.00.scalcen"),),
                             output=str(tmp_path / "d"), keep_order=True))
    assert (tmp_path / "d.fastq").read_bytes() == payload


def test_long_read_mode_rejects_device_placements():
    import pytest
    from scalce_tpu.config import Config
    with pytest.raises(ValueError, match="long-read"):
        Config(mode="compress", inputs=("x",), max_read_len=65536,
               block_reads=256, qual_on_device=True)
    with pytest.raises(ValueError, match="long-read"):
        Config(mode="compress", inputs=("x",), max_read_len=65536,
               block_reads=256, data_parallel=True)


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_auto_placement_follows_default_backend(monkeypatch, backend):
    """AUTO core placement resolves in-process from JAX's default
    backend, with no device probe: the accelerator path on a GPU, the
    native host path on a machine without one."""
    import jax
    from scalce_tpu.pipeline import encode as enc_mod
    if not enc_mod.host_core_available():
        pytest.skip("native host library unavailable")
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = Config(mode="compress", inputs=("x",), block_reads=1024,
                 max_read_len=128)
    assert cfg.core_on_device is None          # AUTO is the default
    enc = enc_mod.BlockEncoder(cfg)
    assert enc.host_core == (backend != "gpu")
    # an explicit placement is never overridden by the backend
    dev = enc_mod.BlockEncoder(Config(mode="compress", inputs=("x",),
                                      block_reads=1024, max_read_len=128,
                                      core_on_device=True))
    assert not dev.host_core


def test_long_read_v6_minimizer_reorder_roundtrip_and_ratio(tmp_path):
    """Container v6 (VERDICT r3 #6): overlapping long reads must be
    minimizer-reordered and delta-coded — byte-exact --keep-order
    round-trip AND a sequence stream well under the 2-bit literal floor
    (EXPERIMENTS.md §14 measured 1.7-3.4x; gate at 1.5x)."""
    import numpy as np
    from scalce_tpu.config import Config
    from scalce_tpu.pipeline import driver

    rng = np.random.default_rng(5)
    genome = rng.choice(list(b"ACGT"), size=120_000).astype(np.uint8)
    L = 40_000
    reads = []
    n = 48                       # ~12x coverage
    total_bases = 0
    for i in range(n):
        ln = int(rng.integers(L // 2, L + 1))
        s = int(rng.integers(0, len(genome) - ln))
        seq = genome[s:s + ln].copy()
        e = rng.random(ln) < 0.005
        seq[e] = rng.choice(list(b"ACGT"), size=int(e.sum()))
        qv = np.clip(np.cumsum(rng.integers(-1, 2, size=ln)) + 20,
                     2, 50).astype(np.uint8) + 33
        reads.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(),
                                             qv.tobytes()))
        total_bases += ln
    payload = b"".join(reads)
    inp = tmp_path / "long.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=256,
                 max_read_len=L, qual_context_order=1)
    driver.compress(cfg)
    import os
    r_bytes = os.path.getsize(tmp_path / "o.00.scalcer")
    assert r_bytes * 1.5 < total_bases / 4, (r_bytes, total_bases // 4)
    driver.decompress(Config(mode="decompress",
                             inputs=(str(tmp_path / "o.00.scalcen"),),
                             output=str(tmp_path / "d"),
                             keep_order=True))
    assert (tmp_path / "d.fastq").read_bytes() == payload


def test_long_read_v6_paired_pair_sync(tmp_path):
    """Paired long-read mode: mate 2 must follow mate 1's minimizer
    order (pair-sync invariant) and still round-trip exactly."""
    import numpy as np
    from scalce_tpu.config import Config
    from scalce_tpu.pipeline import driver

    rng = np.random.default_rng(9)
    genome = rng.choice(list(b"ACGT"), size=80_000).astype(np.uint8)
    L = 33_008                   # > 32752 and % 16 == 0
    p1, p2 = [], []
    pairs = []
    for i in range(24):
        ln = int(rng.integers(L // 2, L + 1))
        s = int(rng.integers(0, len(genome) - ln - 500))
        s2 = s + int(rng.integers(100, 500))
        ln2 = min(ln, len(genome) - s2)
        q1 = (np.clip(rng.integers(20, 40, ln), 2, 50) + 33
              ).astype(np.uint8)
        q2 = (np.clip(rng.integers(20, 40, ln2), 2, 50) + 33
              ).astype(np.uint8)
        s1b = genome[s:s + ln].tobytes()
        s2b = genome[s2:s2 + ln2].tobytes()
        p1.append(b"@p%d/1\n%s\n+\n%s\n" % (i, s1b, q1.tobytes()))
        p2.append(b"@p%d/2\n%s\n+\n%s\n" % (i, s2b, q2.tobytes()))
        pairs.append((s1b, s2b))
    (tmp_path / "m1.fastq").write_bytes(b"".join(p1))
    (tmp_path / "m2.fastq").write_bytes(b"".join(p2))
    cfg = Config(mode="compress",
                 inputs=(str(tmp_path / "m1.fastq"),
                         str(tmp_path / "m2.fastq")),
                 output=str(tmp_path / "o"), block_reads=256,
                 max_read_len=L, qual_context_order=1, paired=True)
    driver.compress(cfg)
    driver.decompress(Config(mode="decompress",
                             inputs=(str(tmp_path / "o.00_1.scalcen"),),
                             output=str(tmp_path / "d")))
    def seqs_of(path):
        ls = path.read_bytes().split(b"\n")
        return [ls[i + 1] for i in range(0, len(ls) - 1, 4)]
    d1 = seqs_of(tmp_path / "d_1.fastq")
    d2 = seqs_of(tmp_path / "d_2.fastq")
    assert set(zip(d1, d2)) == set(pairs)      # pair-sync preserved

def test_long_read_v6_indel_reads_degrade_gracefully(tmp_path):
    """EXPERIMENTS par.11 caveat, pinned: on indel-dominated long reads
    (where fixed-shift masks die at the first indel) the 50% match-rate
    mask floor must zero the masks so the seq stream degrades to
    near-literal cost instead of REGRESSING below it (mask bytes +
    useless shifts must not exceed ~12% over the 2-bit floor), and the
    round-trip must stay byte-exact."""
    import numpy as np
    from scalce_tpu.config import Config
    from scalce_tpu.pipeline import driver

    rng = np.random.default_rng(11)
    genome = rng.choice(list(b"ACGT"), size=100_000).astype(np.uint8)
    L = 32_768
    reads = []
    total_bases = 0
    for i in range(40):                    # ~10x coverage, 2% indels
        ln = int(rng.integers(L // 2, L - 1024))
        s = int(rng.integers(0, len(genome) - ln - 64))
        seq = list(genome[s:s + ln])
        out = []
        for b in seq:
            r = rng.random()
            if r < 0.01:
                continue                   # deletion
            out.append(b)
            if r > 0.99:                   # insertion
                out.append(int(rng.choice(list(b"ACGT"))))
        seq = np.asarray(out, np.uint8)
        qv = np.full(len(seq), 30, np.uint8) + 33
        reads.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(),
                                             qv.tobytes()))
        total_bases += len(seq)
    payload = b"".join(reads)
    inp = tmp_path / "indel.fastq"
    inp.write_bytes(payload)
    import os
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=256,
                 max_read_len=L, qual_context_order=1)
    driver.compress(cfg)
    r_bytes = os.path.getsize(tmp_path / "o.00.scalcer")
    floor = total_bases / 4
    assert r_bytes < floor * 1.12, (r_bytes, floor)
    driver.decompress(Config(mode="decompress",
                             inputs=(str(tmp_path / "o.00.scalcen"),),
                             output=str(tmp_path / "d"),
                             keep_order=True))
    assert (tmp_path / "d.fastq").read_bytes() == payload


def test_auto_read_len_151bp_no_flags(tmp_path):
    """VERDICT r4 #7: 151 bp HiSeq-class reads must compress with NO
    flags — max_read_len=0 (the default) auto-sizes from the input head
    to ceil16(151)=160 — and round-trip byte-exact under keep-order."""
    from scalce_tpu.io import fastq
    from scalce_tpu.utils.synth import synth_fastq
    payload = synth_fastq(2000, 151, seed=61, n_rate=0.01)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    assert fastq.probe_max_read_len((str(inp),)) == 160
    assert _roundtrip_bytes(tmp_path, payload) == payload


def test_auto_read_len_keeps_128_floor_and_bytes(tmp_path):
    """Inputs at or under 128 bp must resolve to EXACTLY the historical
    width 128 (warmed shapes; byte-stability of every existing output):
    AUTO and an explicit --max-read-len 128 emit identical bytes."""
    import glob
    from scalce_tpu.io import fastq
    from scalce_tpu.utils.synth import synth_fastq
    payload = synth_fastq(2000, 100, seed=62, n_rate=0.01, var_len=True)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    assert fastq.probe_max_read_len((str(inp),)) == 128
    outs = {}
    for tag, width in (("auto", 0), ("fix", 128)):
        cfg = Config(mode="compress", inputs=(str(inp),),
                     output=str(tmp_path / tag), block_reads=256,
                     max_read_len=width)
        driver.compress(cfg)
        outs[tag] = b"".join(
            open(f, "rb").read() for f in
            sorted(glob.glob(str(tmp_path / f"{tag}.*"))))
    assert outs["auto"] == outs["fix"]


def test_auto_read_len_probe_gz_and_ceil16(tmp_path):
    """The probe sees through gzip and rounds up to a multiple of 16;
    stdin is un-probeable (None -> caller keeps the floor)."""
    import gzip
    from scalce_tpu.io import fastq
    from scalce_tpu.utils.synth import synth_fastq
    payload = synth_fastq(500, 137, seed=63)
    gzp = tmp_path / "in.fastq.gz"
    gzp.write_bytes(gzip.compress(payload))
    assert fastq.probe_max_read_len((str(gzp),)) == 144   # ceil16(137)
    assert fastq.probe_max_read_len(("-",)) is None


def _indel_long_reads(rng, genome, n, L, sub, ins, dele):
    reads = []
    span = int(L * (1 + dele + 0.05))
    for i in range(n):
        s = int(rng.integers(0, len(genome) - span))
        src = genome[s:s + span]
        ev = rng.random(span)
        subs = ev < sub
        dels = (ev >= sub) & (ev < sub + dele)
        base = np.where(subs, (src + rng.integers(1, 4, span)) % 4, src)
        out = base[~dels]
        im = rng.random(out.size) < ins
        if im.any():
            out = np.insert(out, np.flatnonzero(im),
                            rng.integers(0, 4, int(im.sum())))
        out = out[:L]
        seq = np.frombuffer(b"ACGT", np.uint8)[out]
        qv = np.full(out.size, 40, np.uint8) + 33
        reads.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.tobytes(),
                                             qv.tobytes()))
    return b"".join(reads)


def test_long_read_v7_multi_anchor_indel_roundtrip_and_win(tmp_path):
    """Container v7 (VERDICT r4 #5): INDEL-bearing overlapping long
    reads must round-trip byte-exact under --keep-order, and the
    multi-anchor segmented delta must beat the literal floor where the
    v6 single fixed shift is a no-op (EXPERIMENTS.md §16: 1.36x at
    0.5% indels; gate conservatively at 1.08x on this small block)."""
    from scalce_tpu.config import Config
    from scalce_tpu.pipeline import driver

    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, 150_000, dtype=np.uint8)
    L = 40_000
    payload = _indel_long_reads(rng, genome, n=56, L=L,
                                sub=0.0025, ins=0.00125, dele=0.00125)
    inp = tmp_path / "long.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=256,
                 max_read_len=1 << 16)
    st = driver.compress(cfg)
    dcfg = Config(mode="decompress",
                  inputs=(str(tmp_path / "o.00.scalcer"),),
                  output=str(tmp_path / "d"), keep_order=True)
    driver.decompress(dcfg)
    assert (tmp_path / "d.fastq").read_bytes() == payload
    total_bases = sum(len(r) for r in payload.split(b"\n")[1::4])
    floor = total_bases / 4          # 2-bit literal floor
    assert st.stream_bytes["r"] < floor / 1.08, \
        (st.stream_bytes["r"], floor)


def test_long_read_v6_scalar_shift_blocks_still_decode(tmp_path):
    """Backward compat: a long-read payload with v6-shaped fields
    (scalar per-read shifts, no ``nseg`` array) must decode through the
    same parser the v7 writer uses."""
    from scalce_tpu.streams import seqs

    rng = np.random.default_rng(4)
    n, L = 6, 64 * 16
    codes = rng.integers(0, 4, (n, L)).astype(np.uint8)
    lens = np.full(n, L, np.int64)
    # rows 1.. copy row 0's prefix at shift 0 for a simple valid mask
    codes[1] = codes[0]
    match = np.zeros((n, L), bool)
    match[1, :100] = True
    valid = np.ones((n, L), bool)
    lits = codes[(~match) & valid]
    delta = {
        "mask_bits": np.packbits(match, axis=1, bitorder="little"),
        "shifts": np.zeros(n, np.int32),       # v6 scalar wide shifts
        "pred_k": np.zeros(n, np.uint8),
        "rc_bits": np.zeros((n + 7) // 8, np.uint8),
        "lit_packed": None, "lits": lits, "n_lits": len(lits),
    }
    # direct payload call (lits ride lit_packed 2-bit like the encoder)
    padded = np.zeros(((len(lits) + 15) // 16) * 16, np.uint8)
    padded[:len(lits)] = lits
    delta["lit_packed"] = seqs._pack2bit_np(padded)
    del delta["lits"]
    blob = seqs.payload(delta, lens.astype(np.int32), n,
                        np.zeros(0, np.uint64), np.zeros(0, np.uint8),
                        np.arange(n, dtype=np.int64), backend="zstd")
    out_codes, out_lens, nn, _, _, _, _ = seqs.parse(blob, n, L)
    assert nn == n
    np.testing.assert_array_equal(out_codes, codes)


def test_auto_read_len_probe_fifo_returns_none(tmp_path):
    """Non-seekable inputs (FIFOs / process substitution) must keep the
    128 floor instead of crashing or consuming the stream head: the
    probe declines BEFORE opening (opening a FIFO read-only would block
    for a writer)."""
    import os as _os
    from scalce_tpu.io import fastq
    fifo = str(tmp_path / "pipe")
    _os.mkfifo(fifo)
    assert fastq.probe_max_read_len((fifo,)) is None
