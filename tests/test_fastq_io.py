"""FASTQ parse/write round-trip tests (host layer)."""

import os
import gzip
import io

import numpy as np
import pytest

from scalce_tpu.io import fastq
from scalce_tpu.utils.synth import synth_fastq


def _parse_all(payload: bytes, tmp_path, capacity=256, max_len=128, gz=False):
    p = tmp_path / ("in.fastq.gz" if gz else "in.fastq")
    p.write_bytes(gzip.compress(payload) if gz else payload)
    return list(fastq.iter_blocks(str(p), capacity, max_len))


def _rebuild(blocks):
    out = io.BytesIO()
    for b in blocks:
        fastq.write_fastq_records(out, b.seq, b.qual, b.lengths, b.n_reads,
                                  b.exc_pos, b.exc_byte, b.names, b.plus)
    return out.getvalue()


@pytest.mark.parametrize("gz", [False, True])
def test_roundtrip_identity(tmp_path, gz):
    payload = synth_fastq(1000, 100, seed=1)
    blocks = _parse_all(payload, tmp_path, gz=gz)
    assert sum(b.n_reads for b in blocks) == 1000
    assert len(blocks) == 4  # 256-read capacity
    assert _rebuild(blocks) == payload


def test_var_len_and_n_bases(tmp_path):
    payload = synth_fastq(500, 90, seed=2, var_len=True, n_rate=0.05)
    blocks = _parse_all(payload, tmp_path)
    assert _rebuild(blocks) == payload
    # exceptions recorded for N bases
    assert sum(b.exc_pos.size for b in blocks) > 0
    for b in blocks:
        assert np.all(b.seq < 4)


def test_plus_line_with_name(tmp_path):
    rec = b"@r1\nACGT\n+r1 again\nIIII\n@r2\nTTTT\n+\nJJJJ\n"
    blocks = _parse_all(rec, tmp_path)
    assert blocks[0].plus.to_list() == [b"r1 again", b""]
    assert _rebuild(blocks) == rec


def test_crlf_tolerated(tmp_path):
    rec = b"@r1\r\nACGT\r\n+\r\nIIII\r\n"
    blocks = _parse_all(rec, tmp_path)
    assert blocks[0].n_reads == 1
    assert blocks[0].names.to_list() == [b"r1"]
    assert bytes(blocks[0].qual[0, :4]) == b"IIII"


def test_lowercase_and_iupac_preserved(tmp_path):
    rec = b"@r\nacgtNRYK\n+\nIIIIIIII\n"
    blocks = _parse_all(rec, tmp_path)
    assert _rebuild(blocks) == rec


def test_malformed_raises(tmp_path):
    with pytest.raises(ValueError):
        _parse_all(b"ACGT\n@x\n+\nII\n", tmp_path)
    with pytest.raises(ValueError):
        _parse_all(b"@r\nACGT\n+\nII\n", tmp_path)  # len mismatch
    with pytest.raises(ValueError):
        _parse_all(b"@r\nACGT\n+\nIIII\n@t\nAC\n", tmp_path)  # truncated


def test_paired_lockstep(tmp_path):
    from scalce_tpu.utils.synth import synth_pair
    a, b = synth_pair(300, 80, seed=3)
    p1, p2 = tmp_path / "1.fq", tmp_path / "2.fq"
    p1.write_bytes(a)
    p2.write_bytes(b)
    pairs = list(fastq.iter_paired_blocks(str(p1), str(p2), 128, 128))
    assert sum(x.n_reads for x, _ in pairs) == 300
    for x, y in pairs:
        assert x.n_reads == y.n_reads


def test_block_capacity_padding(tmp_path):
    payload = synth_fastq(10, 50, seed=4)
    blocks = _parse_all(payload, tmp_path, capacity=64, max_len=64)
    b = blocks[0]
    assert b.capacity == 64 and b.n_reads == 10
    assert np.all(b.lengths[10:] == 0)
    assert np.all(b.seq[10:] == 0)


def test_crlf_input_roundtrip(tmp_path):
    payload = synth_fastq(200, 80, seed=30)
    crlf = payload.replace(b"\n", b"\r\n")
    p = tmp_path / "crlf.fastq"
    p.write_bytes(crlf)
    blocks = list(fastq.iter_blocks(str(p), 256, 96))
    assert sum(b.n_reads for b in blocks) == 200
    # content equals the LF version's content
    assert _rebuild(blocks) == payload


def test_stdin_input(tmp_path, monkeypatch):
    import io as _io
    import sys
    payload = synth_fastq(100, 80, seed=31)
    monkeypatch.setattr(sys, "stdin",
                        type("S", (), {"buffer": _io.BytesIO(payload)})())
    blocks = list(fastq.iter_blocks("-", 256, 96))
    assert sum(b.n_reads for b in blocks) == 100
    assert _rebuild(blocks) == payload


def test_read_longer_than_max_len_rejected(tmp_path):
    long_read = b"@r1\n" + b"A" * 200 + b"\n+\n" + b"I" * 200 + b"\n"
    p = tmp_path / "long.fastq"
    p.write_bytes(long_read)
    with pytest.raises(ValueError, match="max_read_len|max-read-len"):
        list(fastq.iter_blocks(str(p), 64, 128))


def test_records_crossing_read_chunks(tmp_path, monkeypatch):
    """Force tiny stream chunks so records straddle bundle boundaries
    (normally only exercised by >32MB inputs)."""
    monkeypatch.setattr(fastq, "_CHUNK_BYTES", 97)   # prime, mid-record
    payload = synth_fastq(300, 80, seed=40, var_len=True)
    p = tmp_path / "in.fastq"
    p.write_bytes(payload)
    blocks = list(fastq.iter_blocks(str(p), 128, 96))
    assert sum(b.n_reads for b in blocks) == 300
    assert _rebuild(blocks) == payload


from scalce_tpu.utils.synth import bgzf_compress as _bgzf_compress


def test_bgzf_parallel_input_roundtrip(tmp_path):
    """BGZF multi-member input must parse identically to plain input
    through the parallel member-inflate path (VERDICT r2 missing #5)."""
    from scalce_tpu.io import fastq as fq
    payload = synth_fastq(6000, 80, seed=3)
    p = tmp_path / "in.fastq.gz"
    p.write_bytes(_bgzf_compress(payload, block=50000))
    # the open path must actually pick the parallel reader
    r = fq._open_maybe_gz(str(p))
    assert isinstance(r, fq._BgzfParallelReader)
    got = r.read()
    r.close()
    assert got == payload
    # and the block parser consumes it end-to-end
    blocks = list(fq.iter_blocks(str(p), 2048, 96))
    assert sum(b.n_reads for b in blocks) == 6000


def test_bgzf_then_plain_member_falls_back(tmp_path):
    """A BGZF prefix concatenated with a PLAIN gzip member must still
    inflate completely (sequential fallback from the first non-BGZF
    member)."""
    import gzip as _g
    from scalce_tpu.io import fastq as fq
    a = synth_fastq(2000, 60, seed=4)
    b = synth_fastq(1500, 60, seed=5)
    p = tmp_path / "mix.fastq.gz"
    bg = _bgzf_compress(a, block=30000)
    p.write_bytes(bg[:-28] + _g.compress(b))   # drop EOF marker, chain
    r = fq._open_maybe_gz(str(p))
    got = r.read()
    r.close()
    assert got == a + b


def test_single_member_gz_readahead(tmp_path):
    """Single-member gzip goes through the read-ahead inflate thread
    and must round-trip via readinto of odd sizes."""
    import gzip as _g
    from scalce_tpu.io import fastq as fq
    payload = synth_fastq(3000, 70, seed=6)
    p = tmp_path / "one.fastq.gz"
    p.write_bytes(_g.compress(payload))
    r = fq._open_maybe_gz(str(p))
    assert isinstance(r, fq._ReadAheadReader)
    got = bytearray()
    while True:
        buf = bytearray(12345)
        k = r.readinto(buf)
        if not k:
            break
        got += buf[:k]
    r.close()
    assert bytes(got) == payload


def test_bgzf_splitter_fuzz(tmp_path):
    """Randomized BGZF member sizes + random byte corruption: the
    parallel splitter must either inflate to exactly the right bytes
    (clean files) or raise (corrupt files) — never hang, crash, or
    return wrong data silently... except where the corruption is
    entirely inside one member's DATA with a matching CRC, which zlib
    itself defines as detection's limit."""
    import zlib as _z
    from scalce_tpu.io import fastq as fq
    rng = np.random.default_rng(77)
    for trial in range(12):
        n = int(rng.integers(1, 5000))
        payload = synth_fastq(n, int(rng.integers(20, 120)), seed=trial)
        block = int(rng.integers(100, 70000))
        data = _bgzf_compress(payload, block=block)
        p = tmp_path / f"f{trial}.gz"
        if trial % 3 == 2:
            # corrupt one random byte
            b = bytearray(data)
            pos = int(rng.integers(0, len(b)))
            b[pos] ^= 0xFF
            p.write_bytes(bytes(b))
            r = fq._open_maybe_gz(str(p))
            try:
                got = r.read()
                # a flipped byte that still inflates cleanly must at
                # least not blow past the real payload's length bound
                assert len(got) <= len(payload) + 70000
            except (ValueError, _z.error, OSError):
                pass          # detected corruption: correct behavior
            finally:
                r.close()
        else:
            p.write_bytes(data)
            r = fq._open_maybe_gz(str(p))
            got = r.read()
            r.close()
            assert got == payload, f"trial {trial}"


def test_readahead_inflate_error_raises_not_hangs(tmp_path):
    """A deflate error while the read-ahead queue is FULL must still
    reach the consumer (the sentinel put retries; code-review r3)."""
    import gzip as _g
    import zlib as _z
    from scalce_tpu.io import fastq as fq
    payload = synth_fastq(20000, 100, seed=9)
    data = bytearray(_g.compress(payload, 1))
    data[len(data) // 2] ^= 0xFF          # corrupt mid-stream
    p = tmp_path / "bad.gz"
    p.write_bytes(bytes(data))
    r = fq._open_maybe_gz(str(p))
    assert isinstance(r, fq._ReadAheadReader)
    with pytest.raises((_z.error, ValueError, OSError)):
        while True:
            buf = bytearray(1 << 16)      # tiny reads keep the queue full
            if not r.readinto(buf):
                break
    r.close()


def test_bz2_input_roundtrip(tmp_path):
    """bzip2 FASTQ input auto-detected by the BZh magic, mirroring the
    reference's buffio bz read mode [REF: scalce buffio.c — UNVERIFIED;
    SURVEY.md §2 L0]."""
    import bz2 as _bz
    payload = synth_fastq(800, 100, seed=11)
    p = tmp_path / "in.fastq.bz2"
    p.write_bytes(_bz.compress(payload, 9))
    blocks = list(fastq.iter_blocks(str(p), 256, 128))
    assert sum(b.n_reads for b in blocks) == 800
    assert _rebuild(blocks) == payload


def test_block_pool_recycling_identical_and_shape_safe(tmp_path):
    """Recycled ReadBlock arrays must change nothing: parsing after
    recycle_block yields the same bytes as fresh arrays (fill(0)
    replaces np.zeros), and a shape change evicts stale pool entries
    instead of disabling recycling or handing out the wrong shape."""
    payload = synth_fastq(600, 100, seed=21, n_rate=0.01, var_len=True)
    p = tmp_path / "in.fastq"
    p.write_bytes(payload)

    fastq._BLOCK_POOL.clear()
    fresh = list(fastq.iter_blocks(str(p), 256, 128))
    want = _rebuild(fresh)
    for b in fresh:
        fastq.recycle_block(b)
    assert len(fastq._BLOCK_POOL) > 0          # blocks actually pooled
    pooled_ids = {id(t[0]) for t in fastq._BLOCK_POOL}

    again = list(fastq.iter_blocks(str(p), 256, 128))
    # the recycled arrays were really reused...
    assert any(id(b.seq) in pooled_ids for b in again)
    # ...and the parse is byte-identical
    assert _rebuild(again) == want

    # wrong-shape entries are EVICTED on pop, not matched — including
    # the lockout case: a pool FULL of stale-shape triples must drain
    # so recycling keeps working after a block-geometry change
    for b in again:
        fastq.recycle_block(b)
    while len(fastq._BLOCK_POOL) < fastq._BLOCK_POOL_MAX:
        fastq._BLOCK_POOL.append(fastq._BLOCK_POOL[0])
    other = list(fastq.iter_blocks(str(p), 512, 128))
    assert all(b.seq.shape == (512, 128) for b in other)
    assert _rebuild(other) == want
    assert not any(t[0].shape == (256, 128) for t in fastq._BLOCK_POOL)
    # pool drained of stale shapes -> new-shape recycling admits again
    fastq.recycle_block(other[0])
    assert any(t[0].shape == (512, 128) for t in fastq._BLOCK_POOL)
    fastq._BLOCK_POOL.clear()


def test_poison_recycle_mode_keeps_roundtrip_identical(tmp_path):
    """SCALCE_POISON_RECYCLE=1 (ADVICE r4 debug mode) overwrites
    recycled arrays with a sentinel instead of pooling them.  A full
    compress must emit IDENTICAL bytes under poison — proving nothing
    downstream of assemble still reads block.seq/qual/lengths — and the
    pool must stay empty."""
    import subprocess
    import sys
    payload = synth_fastq(3000, 100, seed=33, n_rate=0.01, var_len=True)
    p = tmp_path / "in.fastq"
    p.write_bytes(payload)
    outs = {}
    for tag, poison in (("plain", "0"), ("poison", "1")):
        env = dict(os.environ)
        env.update({"JAX_PLATFORMS": "cpu",
                    "SCALCE_POISON_RECYCLE": poison})
        out = tmp_path / tag
        r = subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.argv=['x']; "
             "from scalce_tpu.config import Config; "
             "from scalce_tpu.pipeline import driver; "
             f"driver.compress(Config(mode='compress', "
             f"inputs=({str(p)!r},), output={str(out)!r}, "
             f"block_reads=1024, core_on_device=False))"],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        assert r.returncode == 0, r.stderr[-2000:]
        outs[tag] = b"".join(
            f.read_bytes() for f in sorted(tmp_path.glob(f"{tag}.*")))
    assert outs["plain"] == outs["poison"]
