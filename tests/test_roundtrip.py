"""End-to-end compress→decompress round-trip property tests through the
public CLI/driver surface (SURVEY.md §5: sort-invariant multiset equality
of records — the tool reorders by design, like the reference)."""

import gzip

import numpy as np
import pytest

from scalce_tpu import cli, container
from scalce_tpu.config import Config
from scalce_tpu.pipeline import driver
from scalce_tpu.utils.synth import synth_fastq


def _records(payload: bytes):
    lines = payload.decode().splitlines()
    assert len(lines) % 4 == 0
    recs = []
    for i in range(0, len(lines), 4):
        recs.append(tuple(lines[i:i + 4]))
    return recs


def _roundtrip(tmp_path, payload: bytes, gz=False, **cfg_kw):
    inp = tmp_path / ("in.fastq.gz" if gz else "in.fastq")
    inp.write_bytes(gzip.compress(payload) if gz else payload)
    out_prefix = str(tmp_path / "out")
    cfg = Config(mode="compress", inputs=(str(inp),), output=out_prefix,
                 block_reads=1 << 10, **cfg_kw)
    enc_stats = driver.compress(cfg)
    dec_prefix = str(tmp_path / "dec")
    dcfg = Config(mode="decompress", inputs=(out_prefix + ".00.scalcen",),
                  output=dec_prefix, block_reads=1 << 10, **cfg_kw)
    driver.decompress(dcfg)
    got = (tmp_path / "dec.fastq").read_bytes()
    return enc_stats, got


@pytest.mark.parametrize("gz", [False, True])
def test_lossless_roundtrip_multiset(tmp_path, gz):
    payload = synth_fastq(3000, 100, seed=11, var_len=True, n_rate=0.01)
    stats, got = _roundtrip(tmp_path, payload, gz=gz)
    assert stats.n_reads == 3000
    assert sorted(_records(got)) == sorted(_records(payload))


def test_roundtrip_compresses_vs_gzip(tmp_path):
    # overlapping reads from a small genome: reorder + split must beat
    # plain gzip of the FASTQ clearly
    import zlib
    payload = synth_fastq(8192, 100, seed=12, genome_len=50_000,
                          n_rate=0.001)
    stats, got = _roundtrip(tmp_path, payload)
    assert sorted(_records(got)) == sorted(_records(payload))
    gz_size = len(zlib.compress(payload, 6))
    assert stats.output_bytes < gz_size, (stats.output_bytes, gz_size)


def test_roundtrip_name_template(tmp_path):
    payload = synth_fastq(500, 80, seed=13)
    stats, got = _roundtrip(tmp_path, payload, name_lib="mylib")
    recs = _records(got)
    # names regenerated as @mylib.N in output order, 1-based contiguous
    assert [r[0] for r in recs] == [f"@mylib.{i+1}" for i in range(len(recs))]
    # seq/qual multiset preserved
    assert sorted(r[1:] for r in recs) == sorted(
        r[1:] for r in _records(payload))


def test_roundtrip_part_splitting(tmp_path):
    payload = synth_fastq(6000, 100, seed=14)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "out"), block_reads=1 << 10,
                 part_size=100_000)
    driver.compress(cfg)
    parts = sorted(p.name for p in tmp_path.glob("out.*.scalcer"))
    assert len(parts) > 1, parts
    dcfg = Config(mode="decompress",
                  inputs=(str(tmp_path / "out.00.scalcen"),),
                  output=str(tmp_path / "dec"), block_reads=1 << 10)
    driver.decompress(dcfg)
    got = (tmp_path / "dec.fastq").read_bytes()
    assert sorted(_records(got)) == sorted(_records(payload))


def test_cli_main_end_to_end(tmp_path):
    payload = synth_fastq(1200, 96, seed=15, var_len=True)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    rc = cli.main([str(inp), "-o", str(tmp_path / "o"), "--stats-json",
                   "--block-reads", "1024"])
    assert rc == 0
    rc = cli.main(["-d", str(tmp_path / "o.00.scalceq"), "-o",
                   str(tmp_path / "d"), "--block-reads", "1024"])
    assert rc == 0
    got = (tmp_path / "d.fastq").read_bytes()
    assert sorted(_records(got)) == sorted(_records(payload))


def test_truncated_container_detected(tmp_path):
    payload = synth_fastq(300, 80, seed=16)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "out"), block_reads=1 << 10)
    driver.compress(cfg)
    r = tmp_path / "out.00.scalcer"
    data = r.read_bytes()
    r.write_bytes(data[:-10])       # torn write
    dcfg = Config(mode="decompress",
                  inputs=(str(tmp_path / "out.00.scalcen"),),
                  output=str(tmp_path / "dec"), block_reads=1 << 10)
    with pytest.raises(ValueError, match="torn|trunc|corrupt"):
        driver.decompress(dcfg)


def test_keep_order_byte_exact(tmp_path):
    """--keep-order restores the EXACT input bytes (beyond ref parity)."""
    payload = synth_fastq(2500, 100, seed=17, var_len=True, n_rate=0.01)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "out"), block_reads=1 << 10)
    driver.compress(cfg)
    dcfg = Config(mode="decompress",
                  inputs=(str(tmp_path / "out.00.scalcer"),),
                  output=str(tmp_path / "dec"), block_reads=1 << 10,
                  keep_order=True)
    driver.decompress(dcfg)
    assert (tmp_path / "dec.fastq").read_bytes() == payload


def test_name_stream_is_small_for_structured_names(tmp_path):
    payload = synth_fastq(4096, 100, seed=18)      # SRA-style names
    stats, got = _roundtrip(tmp_path, payload)
    assert sorted(_records(got)) == sorted(_records(payload))
    # original-order numeric deltas: name stream well under 1 B/read
    assert stats.stream_bytes["n"] < 4096, stats.stream_bytes


@pytest.mark.parametrize("backend", ["bz", "no"])
def test_backend_modes_roundtrip(tmp_path, backend):
    payload = synth_fastq(1500, 100, seed=19)
    stats, got = _roundtrip(tmp_path, payload, backend=backend)
    assert sorted(_records(got)) == sorted(_records(payload))


def test_thread_count_never_changes_bytes(tmp_path):
    """-T is pure concurrency: worker count must not affect output bytes
    (the functional-purity analogue of race-freedom, SURVEY.md §6)."""
    payload = synth_fastq(5000, 100, seed=22, var_len=True, n_rate=0.004)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    outs = {}
    for t in (1, 8):
        out = str(tmp_path / f"t{t}")
        cfg = Config(mode="compress", inputs=(str(inp),), output=out,
                     block_reads=1 << 10, threads=t)
        driver.compress(cfg)
        outs[t] = b"".join(
            (tmp_path / f"t{t}.00{ext}").read_bytes()
            for ext in (".scalcen", ".scalcer", ".scalceq"))
    assert outs[1] == outs[8]


def test_rc_reads_roundtrip_and_bucket_together(tmp_path):
    """Reads from both strands round-trip byte-exactly, and strand
    canonicalization makes RC duplicates compress like same-strand
    duplicates (scalce_tpu improves on the reference here: its core
    matching is strand-sensitive)."""
    import zlib
    fwd = synth_fastq(4096, 100, seed=23, genome_len=30_000, rc_rate=0.0)
    both = synth_fastq(4096, 100, seed=23, genome_len=30_000, rc_rate=0.5)
    sizes = {}
    for tag, payload in (("fwd", fwd), ("both", both)):
        inp = tmp_path / f"{tag}.fastq"
        inp.write_bytes(payload)
        cfg = Config(mode="compress", inputs=(str(inp),),
                     output=str(tmp_path / tag), block_reads=1 << 12)
        st = driver.compress(cfg)
        sizes[tag] = st.stream_bytes["r"]
        dcfg = Config(mode="decompress",
                      inputs=(str(tmp_path / f"{tag}.00.scalcer"),),
                      output=str(tmp_path / f"d{tag}"),
                      block_reads=1 << 12, keep_order=True)
        driver.decompress(dcfg)
        assert (tmp_path / f"d{tag}.fastq").read_bytes() == payload
    # mixed-strand input must compress within 15% of single-strand
    assert sizes["both"] < 1.15 * sizes["fwd"], sizes


def test_profile_and_verbose_flags(tmp_path, capsys):
    payload = synth_fastq(300, 80, seed=24)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    prof = tmp_path / "trace"
    rc = cli.main([str(inp), "-o", str(tmp_path / "o"), "-v",
                   "--profile", str(prof), "--block-reads", "256"])
    assert rc == 0
    assert prof.exists() and any(prof.rglob("*"))


def test_decompress_to_stdout(tmp_path, capfdbinary):
    payload = synth_fastq(400, 80, seed=25)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "o"), block_reads=512)
    driver.compress(cfg)
    dcfg = Config(mode="decompress", inputs=(str(tmp_path / "o.00.scalcen"),),
                  output="-", keep_order=True)
    driver.decompress(dcfg)
    out, _ = capfdbinary.readouterr()
    assert out == payload


def test_literal_rans_engages_on_biased_composition(tmp_path):
    """Biased base composition (GC-poor) makes the literal stream
    compressible: the per-block trial must pick the rANS mode and still
    round-trip exactly; uniform literals keep the raw 2-bit packing."""
    import numpy as np
    from scalce_tpu import container
    from scalce_tpu.config import Config
    from scalce_tpu.pipeline import driver
    from scalce_tpu.utils.synth import synth_fastq

    rng = np.random.default_rng(8)
    # AT-rich genome: literals carry ~1.4 bits/base, well under 2
    genome = rng.choice(np.array([0, 3, 0, 3, 0, 3, 1, 2], np.uint8),
                        size=200_000)
    payload = synth_fastq(4096, 100, seed=9, genome=genome, n_rate=0.001)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    cfg = Config(mode="compress", inputs=(str(inp),),
                 output=str(tmp_path / "out"), block_reads=4096)
    driver.compress(cfg)
    from scalce_tpu.container import TripletReader
    r = TripletReader(str(tmp_path / "out.00.scalcer"))
    modes = []
    for bid, payloads in r.iter_blocks():
        a = container.unpack_arrays(payloads["r"])
        modes.append(int(a["lit_mode"][0]))
    assert 1 in modes, "rANS literal mode never engaged on biased data"
    dcfg = Config(mode="decompress",
                  inputs=(str(tmp_path / "out.00.scalcen"),),
                  output=str(tmp_path / "dec"), block_reads=4096)
    driver.decompress(dcfg)
    def recs(p):
        ls = open(p, "rb").read().split(b"\n")
        return sorted(tuple(ls[i:i + 4]) for i in range(0, len(ls) - 1, 4))
    assert recs(str(inp)) == recs(str(tmp_path / "dec.fastq"))


def test_delta_placement_never_changes_bytes(tmp_path):
    """Host-placed delta (native byte-compare match) and device-placed
    delta (_delta_seq) must emit IDENTICAL payloads — placement is a
    bandwidth decision, never a format one.  Covers single-end and
    paired, with ragged lengths and N exceptions."""
    import numpy as np
    from scalce_tpu.config import Config
    from scalce_tpu.io import fastq
    from scalce_tpu.pipeline.encode import BlockEncoder, \
        host_delta_available
    from scalce_tpu.utils.synth import synth_fastq

    if not host_delta_available():
        import pytest
        pytest.skip("native delta_match unavailable")
    p1 = tmp_path / "a.fastq"
    p2 = tmp_path / "b.fastq"
    p1.write_bytes(synth_fastq(2048, 100, seed=21, var_len=True,
                               n_rate=0.01))
    p2.write_bytes(synth_fastq(2048, 100, seed=22, var_len=True,
                               n_rate=0.01))
    b1 = next(fastq.iter_blocks(str(p1), 2048, 128))
    b2 = next(fastq.iter_blocks(str(p2), 2048, 128))
    host = BlockEncoder(Config(mode="compress", inputs=("x",),
                               block_reads=2048))
    dev = BlockEncoder(Config(mode="compress", inputs=("x",),
                              block_reads=2048, delta_on_device=True))
    assert host.host_delta and not dev.host_delta
    eh, ed = host.encode_block(b1), dev.encode_block(b1)
    assert eh.payloads == ed.payloads
    ph = host.encode_block_pair(b1, b2)
    pd = dev.encode_block_pair(b1, b2)
    for h, d in zip(ph, pd):
        assert h.payloads == d.payloads


def test_delta_match_runs_equals_ck_variant():
    """The boundary-bit matcher (slim D2H buffer) must reproduce the
    core-id matcher exactly on sorted bucket runs, including NO_CORE
    singleton exclusion and K-window truncation at run starts."""
    import numpy as np
    from scalce_tpu import native
    from scalce_tpu.pipeline.encode import host_delta_available

    if not host_delta_available():
        import pytest
        pytest.skip("native delta_match unavailable")
    rng = np.random.default_rng(11)
    n, L = 512, 64
    NO_CORE = np.uint32(0xFFFFFFFF)
    # sorted run structure: runs of length 1..9, last 30 rows NO_CORE
    ck = np.empty(n, np.uint32)
    i, run_id = 0, 0
    while i < n - 30:
        rl = int(rng.integers(1, 10))
        ck[i:i + rl] = run_id
        i += rl
        run_id += 1
    ck[max(i - 1, n - 30):] = NO_CORE
    ck[n - 30:] = NO_CORE
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    lens = rng.integers(40, L + 1, size=n).astype(np.int64)
    cp = rng.integers(0, 30, size=n).astype(np.int32)
    for row in range(n):
        codes[row, lens[row]:] = 0
    bnd = np.ones(n, np.uint8)
    bnd[1:] = (ck[1:] != ck[:-1]) | (ck[1:] == NO_CORE)
    a = native.delta_match(codes, ck, cp, lens, 4)
    b = native.delta_match_runs(codes, bnd, cp, lens, 4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_core_placement_never_changes_bytes(tmp_path):
    """Host-placed core matching (native matcher + stable bucket sort)
    and device-placed core matching must emit IDENTICAL payloads —
    the third placement knob after qualities and delta (SURVEY.md §2
    "LCE tokenizer"/"Bucket manager": the reference's host stage as a
    bandwidth fallback).  Covers strand canonicalization, N-masked
    windows, ragged lengths, and paired-end."""
    import numpy as np
    from scalce_tpu.config import Config
    from scalce_tpu.io import fastq
    from scalce_tpu.pipeline.encode import BlockEncoder, \
        host_core_available
    from scalce_tpu.utils.synth import synth_fastq

    if not host_core_available():
        import pytest
        pytest.skip("native core_match_block unavailable")
    p1 = tmp_path / "a.fastq"
    p2 = tmp_path / "b.fastq"
    p1.write_bytes(synth_fastq(2048, 100, seed=41, var_len=True,
                               n_rate=0.01, rc_rate=0.5))
    p2.write_bytes(synth_fastq(2048, 100, seed=42, var_len=True,
                               n_rate=0.01))
    b1 = next(fastq.iter_blocks(str(p1), 2048, 128))
    b2 = next(fastq.iter_blocks(str(p2), 2048, 128))
    # placement is pinned EXPLICITLY on both sides: AUTO resolves from
    # the default backend (host on this CPU suite), which is not what
    # this byte-identity test is about.
    dev = BlockEncoder(Config(mode="compress", inputs=("x",),
                              block_reads=2048, core_on_device=True))
    host = BlockEncoder(Config(mode="compress", inputs=("x",),
                               block_reads=2048, core_on_device=False))
    assert host.host_core and not dev.host_core
    assert dev.encode_block(b1).payloads == \
        host.encode_block(b1).payloads
    for d, h in zip(dev.encode_block_pair(b1, b2),
                    host.encode_block_pair(b1, b2)):
        assert d.payloads == h.payloads


def test_core_host_cli_end_to_end(tmp_path):
    """--core-host runs the full pipeline with zero device traffic and
    round-trips byte-exactly under --keep-order."""
    from scalce_tpu import cli, container
    payload = synth_fastq(1500, 90, seed=43, n_rate=0.005)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    rc = cli.main(["--core-placement", "host", "--block-reads", "1024",
                   "-o", str(tmp_path / "o"), str(inp)])
    assert rc == 0
    rc = cli.main(["-d", "--keep-order", "-o", str(tmp_path / "d"),
                   str(tmp_path / "o.00.scalcen")])
    assert rc == 0
    assert (tmp_path / "d.fastq").read_bytes() == payload


def test_driver_upload_prefetch_placement_identity(tmp_path):
    """Device placement THROUGH THE DRIVER (upload-prefetch pipeline,
    multiple blocks in flight) must emit bytes identical to the host
    placement — pins the H2D double-buffering added in round 3."""
    import glob
    from scalce_tpu.pipeline import driver
    payload = synth_fastq(3000, 100, seed=77, var_len=True, n_rate=0.01,
                          rc_rate=0.3)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    outs = {}
    for tag, place in (("dev", True), ("host", False)):
        driver.compress(Config(mode="compress", inputs=(str(inp),),
                               output=str(tmp_path / tag),
                               block_reads=512, core_on_device=place))
        outs[tag] = b"".join(
            open(p, "rb").read()
            for p in sorted(glob.glob(str(tmp_path / f"{tag}.*"))))
    assert outs["dev"] == outs["host"]


def test_delta_device_decode_identity(tmp_path):
    """Pointer-doubling device reconstruction (--delta-device decode)
    must emit FASTQ byte-identical to the serial host walk (VERDICT r2
    #2).  Deep chains: low-complexity genome makes most rows copy."""
    from scalce_tpu.pipeline import driver
    payload = synth_fastq(4096, 100, seed=99, var_len=True, n_rate=0.01,
                          rc_rate=0.4, genome_len=4000)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    driver.compress(Config(mode="compress", inputs=(str(inp),),
                           output=str(tmp_path / "o"), block_reads=1024,
                           core_on_device=False))
    outs = {}
    for tag, dev in (("host", False), ("dev", True)):
        driver.decompress(Config(
            mode="decompress", inputs=(str(tmp_path / "o.00.scalcen"),),
            output=str(tmp_path / tag), keep_order=True,
            delta_on_device=dev))
        outs[tag] = (tmp_path / f"{tag}.fastq").read_bytes()
    assert outs["dev"] == outs["host"] == payload


def test_delta_device_rejects_corrupt_chain(tmp_path):
    """The device path's gathers clamp instead of faulting, so the deep
    payload validation must still reject an out-of-bounds copy chain."""
    import pytest
    from scalce_tpu.streams import seqs as seqs_mod
    from scalce_tpu.pipeline import driver
    payload = synth_fastq(256, 64, seed=5)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    driver.compress(Config(mode="compress", inputs=(str(inp),),
                           output=str(tmp_path / "o"), block_reads=256,
                           core_on_device=False))
    reader = container.TripletReader(str(tmp_path / "o.00.scalcen"))
    (bid, payloads), = list(reader.iter_blocks())
    a = container.unpack_arrays(payloads["r"])
    B = int(reader.meta["block_reads"])
    L = int(reader.meta["max_read_len"])
    n = int(a["n_reads"][0])
    # corrupt: a shift that sends a masked copy out of the row
    # (written as the LEGACY raw-i16 array, which parse still accepts)
    bad = {k: v for k, v in a.items()
           if not k.startswith("shv")}
    bad["shifts"] = np.full(n, L - 1, np.int16)
    blob = container.pack_arrays(bad)
    with pytest.raises(ValueError):
        seqs_mod.parse(blob, B, L, delta_device=True)


def test_driver_placement_identity_uniform_blocks(tmp_path):
    """Uniform-length blocks synthesize their device lengths from two
    scalars instead of uploading them — bytes must still match the
    host placement exactly.  (The compact 5-byte hd wire this test
    once pinned was reverted — EXPERIMENTS.md §10.)"""
    import glob
    from scalce_tpu.pipeline import driver
    payload = synth_fastq(3000, 100, seed=88, n_rate=0.01, rc_rate=0.3)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    outs = {}
    for tag, place in (("dev", True), ("host", False)):
        driver.compress(Config(mode="compress", inputs=(str(inp),),
                               output=str(tmp_path / tag),
                               block_reads=512, core_on_device=place))
        outs[tag] = b"".join(
            open(p, "rb").read()
            for p in sorted(glob.glob(str(tmp_path / f"{tag}.*"))))
    assert outs["dev"] == outs["host"]
    # paired: both mates uniform exercises the mate-2 wire next to
    # the mate-1 wire with synthesized lengths on both
    p1 = tmp_path / "m1.fastq"
    p2 = tmp_path / "m2.fastq"
    p1.write_bytes(synth_fastq(1024, 100, seed=90, mate=1))
    p2.write_bytes(synth_fastq(1024, 100, seed=90, mate=2))
    for tag, place in (("pdev", True), ("phost", False)):
        driver.compress(Config(mode="compress", inputs=(str(p1), str(p2)),
                               paired=True, output=str(tmp_path / tag),
                               block_reads=512, core_on_device=place))
        outs[tag] = b"".join(
            open(p, "rb").read()
            for p in sorted(glob.glob(str(tmp_path / f"{tag}.*"))))
    assert outs["pdev"] == outs["phost"]

def test_cli_c_flag_is_backend_alias(tmp_path):
    """``-c gz`` spells the reference's output-mode flag [REF: scalce.c
    -c — UNVERIFIED; SURVEY.md §1] and must behave exactly like
    ``--backend gz``."""
    args = cli.build_parser().parse_args(["in.fq", "-c", "gz"])
    assert args.backend == "gz"
    payload = synth_fastq(600, 80, seed=77)
    inp = tmp_path / "in.fastq"
    inp.write_bytes(payload)
    rc = cli.main([str(inp), "-o", str(tmp_path / "o"), "-c", "gz",
                   "--block-reads", "512"])
    assert rc == 0
    rc = cli.main(["-d", str(tmp_path / "o.00.scalceq"), "-o",
                   str(tmp_path / "d"), "--block-reads", "512"])
    assert rc == 0
    got = (tmp_path / "d.fastq").read_bytes()
    assert sorted(_records(got)) == sorted(_records(payload))
