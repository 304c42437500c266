"""Per-stage decode profile on the bench workload (host placement, CPU).

Encodes the bench FASTQ once (CPU backend — payload bytes are identical
by the determinism invariant), then times each decode stage serially on
one thread so the per-block CPU cost is attributable.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np

from scalce_tpu.config import Config
from scalce_tpu.pipeline import driver
from scalce_tpu.pipeline.decode import BlockDecoder
from scalce_tpu import container
from scalce_tpu.io import fastq
from scalce_tpu.streams import qualities, seqs, names as names_stream
from scalce_tpu.utils.synth import synth_fastq

import tempfile

n_reads = int(os.environ.get("BENCH_READS", 1 << 19))
block_reads = int(os.environ.get("BENCH_BLOCK_READS", 1 << 17))
tmp = tempfile.mkdtemp(prefix="scalce_decprof_")
path = os.path.join(tmp, "bench.fastq")
payload = synth_fastq(n_reads, 100, seed=42, genome_len=1_000_000,
                      n_rate=0.001)
open(path, "wb").write(payload)
print(f"input {len(payload)/1e6:.1f} MB", file=sys.stderr)

cfg = Config(mode="compress", inputs=(path,),
             output=os.path.join(tmp, "bench"), block_reads=block_reads)
t0 = time.monotonic()
driver.compress(cfg)
print(f"encode (cpu, incl compile) {time.monotonic()-t0:.1f}s",
      file=sys.stderr)

reader = container.TripletReader(os.path.join(tmp, "bench.00.scalcen"))
meta = reader.meta
dec = BlockDecoder(meta, keep_order=False, qual_on_device=False)

blocks = list(reader.iter_blocks())
print(f"{len(blocks)} blocks", file=sys.stderr)

T = {}
def tick(k, t):
    T[k] = T.get(k, 0.0) + (time.monotonic() - t)

total0 = time.monotonic()
for bid, payloads in blocks:
    t = time.monotonic()
    parsed = seqs.parse(payloads["r"], int(meta["block_reads"]),
                        int(meta["max_read_len"]))
    tick("seq_parse(reconstruct)", t)
    t = time.monotonic()
    enc_q = qualities.parse(payloads["q"])
    tick("qual_parse", t)
    t = time.monotonic()
    qual = qualities.decode_host(enc_q, parsed[1])
    tick("qual_decode_host", t)
    t = time.monotonic()
    b = dec._finish(payloads, parsed, qual)
    tick("finish(names/rc/align)", t)
    t = time.monotonic()
    buf = fastq.render_fastq_records(b.seq, b.qual, b.lengths, b.n_reads,
                                     b.exc_pos, b.exc_byte, b.names, b.plus)
    tick("render_fastq", t)
total = time.monotonic() - total0
print(f"serial total {total:.2f}s  ({len(payload)/total/1e9:.4f} GB/s "
      f"single-thread)", file=sys.stderr)
for k, v in sorted(T.items(), key=lambda kv: -kv[1]):
    print(f"  {k:28s} {v:7.3f}s  ({v/total*100:4.1f}%)", file=sys.stderr)
