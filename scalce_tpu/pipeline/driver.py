"""Top-level compress/decompress drivers (the reference's ``compress()``
and ``decompress()`` entry points, SURVEY.md §4.1–4.2) plus run stats
(SURVEY.md §6 "Metrics / logging": structured stats instead of the
reference's stderr prints)."""

from __future__ import annotations

import collections
import concurrent.futures as _fut
import dataclasses
import itertools
import json
import os
import queue as _queue
import sys
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from scalce_tpu import container
from scalce_tpu.config import Config
from scalce_tpu.io import fastq
from scalce_tpu.pipeline.decode import BlockDecoder
from scalce_tpu.pipeline.encode import BlockEncoder, file_meta


@dataclasses.dataclass
class RunStats:
    """Structured run metrics (SURVEY.md §6 "Metrics / logging"): the
    reference prints wall-clock + sizes to stderr; this adds per-stream
    bytes, ratio, GB/s, and per-stage seconds (parse / device dispatch /
    host assembly) for observability."""
    mode: str
    n_reads: int = 0
    n_blocks: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    stream_bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"n": 0, "r": 0, "q": 0})
    stage_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0
    placement: str = ""         # resolved compute placement (encode)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if self.input_bytes and self.output_bytes:
            d["ratio"] = self.input_bytes / self.output_bytes
        if self.wall_s > 0:
            d["GBps"] = self.input_bytes / self.wall_s / 1e9
        return json.dumps(d, sort_keys=True)


def _lossy_preamble(cfg: Config, block_iter):
    """Sample the first ``-S`` reads for the lossy histogram, returning
    (qual_map, buffered_blocks, block_iter) — the reference's sampling
    pass (SURVEY.md §4.4) without re-reading the input: sampled blocks
    are buffered and encoded first.

    Multi-host note: when sharded, this histogram must be all-reduced
    across hosts before map construction so every host applies the same
    table (SURVEY.md §6 "Distributed communication backend").
    """
    from scalce_tpu.models import lossy
    if cfg.lossy_pct <= 0:
        return lossy.identity_map(), [], block_iter
    hist = np.zeros(0, np.int64)
    buffered = []
    sampled = 0
    for block in block_iter:
        bs = block if isinstance(block, tuple) else (block,)
        for b in bs:
            h = lossy.sample_histogram(b.qual, b.lengths, b.n_reads)
            hist = h if hist.size == 0 else hist + h
            sampled += b.n_reads
        buffered.append(block)
        if sampled >= cfg.sample_size:
            break
    qual_map = lossy.build_quant_map(hist, cfg.lossy_pct) \
        if hist.size else lossy.identity_map()
    return qual_map, buffered, block_iter


def _prefetch(it: Iterator, depth: int = 3) -> Iterator:
    """Run an iterator in a background thread with a bounded queue —
    overlaps host FASTQ parsing with device encode (the H2D boundary of
    SURVEY.md §4: parse feeds the device asynchronously)."""
    q: _queue.Queue = _queue.Queue(maxsize=depth)
    _END = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                # bounded put with a stop check so an abandoned consumer
                # (emit/writer raised) doesn't leave this thread blocked
                # on a full queue holding the input file open forever
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except _queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:           # propagate parse errors
            err.append(e)
        finally:
            # the sentinel put must also be stop-aware: with the queue
            # full and the consumer gone, an unbounded put would block
            # this thread (and the open input handle) forever
            while not stop.is_set():
                try:
                    q.put(_END, timeout=0.2)
                    break
                except _queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()   # worker notices within its put timeout and exits


def _run_pipelined(blocks: Iterator, encode_device, assemble, emit,
                   workers: int, stage_s: Optional[Dict] = None) -> None:
    """Three-stage block pipeline.

    main thread:   device dispatch per block (stays in submission order)
    worker pool:   assemble (D2H + tables + rANS pass B + deflate)
    emit:          called in block order with each finished result
    """
    times = stage_s if stage_s is not None else {}
    times.setdefault("device_dispatch", 0.0)
    times.setdefault("assemble", 0.0)
    times_lock = threading.Lock()

    def timed(label, fn, *a):
        t0 = time.monotonic()
        r = fn(*a)
        dt = time.monotonic() - t0
        with times_lock:   # pool workers update concurrently
            times[label] += dt
        return r

    if workers <= 1:
        for item in blocks:
            emit(timed("assemble", assemble, item,
                       timed("device_dispatch", encode_device, item)))
        return
    pool = _fut.ThreadPoolExecutor(max_workers=workers)
    pending: collections.deque = collections.deque()
    max_pending = workers + 2
    try:
        for item in blocks:
            devout = timed("device_dispatch", encode_device, item)
            pending.append(pool.submit(timed, "assemble", assemble, item,
                                       devout))
            while len(pending) >= max_pending:
                emit(pending.popleft().result())
        while pending:
            emit(pending.popleft().result())
    finally:
        pool.shutdown(wait=True)


def compress(cfg: Config) -> RunStats:
    t0 = time.monotonic()
    # fail BEFORE output triplets are created: a missing input used to
    # leave torn part files behind (caught only at decompress time)
    for p in cfg.inputs:
        if p != "-" and not os.path.exists(p):
            raise FileNotFoundError(f"input FASTQ not found: {p}")
    # max_read_len=0 (AUTO): size the padded width from the input head
    # BEFORE anything shape-dependent (file_meta stores it; every jit
    # below keys on it).  Deterministic, so output bytes stay a pure
    # function of (input, config).  VERDICT r4 #7.
    from scalce_tpu.config import resolve_read_len
    cfg = resolve_read_len(cfg)
    stats = RunStats(mode="compress")
    meta = file_meta(cfg)

    if cfg.paired:
        return _compress_paired(cfg, stats, meta, t0)

    (path,) = cfg.inputs
    block_iter = fastq.iter_blocks(path, cfg.block_reads, cfg.max_read_len)
    qual_map, buffered, block_iter = _lossy_preamble(cfg, block_iter)
    enc = BlockEncoder(cfg, qual_map)
    stats.placement = "host" if enc.host_core else "device"
    out_prefix, multihost = _host_output(cfg)
    writer = container.TripletWriter(
        out_prefix, meta,
        part_size=0 if multihost else cfg.part_size, mate=None,
        resume=cfg.resume)
    from scalce_tpu.parallel.merge import owns_block
    owned = (b for b in itertools.chain(buffered, block_iter)
             if owns_block(b.block_id, cfg.host_id, cfg.n_hosts)
             and b.block_id not in writer.existing_blocks)

    def emit(eb):
        writer.add_block(eb.block_id, eb.payloads, eb.n_reads)
        stats.n_blocks += 1
        stats.n_reads += eb.n_reads
        for k, p in eb.payloads.items():
            stats.stream_bytes[k] += len(p)
        if cfg.verbose:
            print(f"[scalce_tpu] block {eb.block_id}: {eb.n_reads} reads, "
                  f"{eb.total_bytes} bytes", file=sys.stderr)

    def assemble_recycle(block, devout):
        # assemble is the last reader of the parsed arrays; handing
        # them back lets the parser reuse warm pages (recycle_block
        # docstring has the measured numbers)
        eb = enc.assemble(block, devout)
        fastq.recycle_block(block)
        return eb

    if cfg.data_parallel:
        _run_sharded(cfg, _prefetch(owned), qual_map, emit, stats.stage_s)
    elif enc.host_core or enc.long_mode:
        _run_pipelined(_prefetch(owned), enc.encode_device,
                       assemble_recycle, emit, cfg.threads, stats.stage_s)
    else:
        # device placement: an upload-prefetch stage keeps the next
        # block's H2D in flight while the current block computes.
        # Depth 2 bounds device memory to ~3 in-flight blocks.
        uploaded = ((b, enc.upload(b)) for b in _prefetch(owned))
        _run_pipelined(_prefetch(uploaded, depth=2),
                       lambda it: enc.encode_device(it[0], pre=it[1]),
                       lambda it, devout: enc.assemble(it[0], devout),
                       emit, cfg.threads, stats.stage_s)
    writer.close()
    stats.input_bytes = _file_size(path)
    stats.output_bytes = sum(stats.stream_bytes.values())
    stats.wall_s = time.monotonic() - t0
    return stats


def _run_sharded(cfg: Config, blocks: Iterator, qual_map, emit,
                 stage_s: Optional[Dict] = None, paired: bool = False
                 ) -> None:
    """Single-host multi-device DP: groups of |mesh| blocks per
    super-step (SURVEY.md §3 / BASELINE.json config 4).  Output bytes
    are identical to the single-device path.

    Pipelined like the single-device path: group device dispatches stay
    on the main thread (submission order), group assembly runs on the
    worker pool, emits stay in block order.
    """
    from scalce_tpu.parallel.mesh import ShardedEncoder
    senc = ShardedEncoder(cfg, qual_map)

    def groups():
        group: List = []
        for block in blocks:
            group.append(block)
            if len(group) == senc.D:
                yield group
                group = []
        if group:
            yield group

    # group-upload prefetch: the next group's stacked H2D stays in
    # flight while the current group computes (same overlap the
    # single-device path gets from BlockEncoder.upload)
    if paired:
        uploaded = ((g, senc.upload_group([p[0] for p in g]),
                     senc.upload_group([p[1] for p in g]))
                    for g in groups())
        enc_dev = (lambda it: senc.encode_device_pair(it[0], pre1=it[1],
                                                      pre2=it[2])
                   if len(it[0]) == senc.D else None)
        asm = (lambda it, d: senc.assemble_pair(it[0], d)
               if d is not None
               else [senc._fallback.encode_block_pair(*p) for p in it[0]])
    else:
        uploaded = ((g, senc.upload_group(g)) for g in groups())
        enc_dev = (lambda it: senc.encode_device(it[0], pre=it[1])
                   if len(it[0]) == senc.D else None)
        asm = (lambda it, d: senc.assemble(it[0], d) if d is not None
               else [senc._fallback.encode_block(b) for b in it[0]])

    def emit_group(ebs):
        for eb in ebs:
            emit(eb)

    _run_pipelined(_prefetch(uploaded, depth=2), enc_dev, asm, emit_group,
                   cfg.threads, stage_s)


def _host_output(cfg: Config):
    """Multi-host runs write per-host intermediates; ``merge_hosts``
    interleaves them into the final triplet (SURVEY.md §3 multi-host DP:
    "deterministic ordered gather/merge")."""
    if cfg.n_hosts > 1:
        from scalce_tpu.parallel.merge import host_prefix
        return host_prefix(cfg.output, cfg.host_id), True
    return cfg.output, False


def merge_hosts(cfg: Config) -> int:
    """Rank-0 post-step: merge every host's triplet into the final one."""
    from scalce_tpu.parallel.merge import merge_host_outputs
    mates = (1, 2) if cfg.paired else (None,)
    n = 0
    for mate in mates:
        n += merge_host_outputs(cfg.output, cfg.n_hosts,
                                part_size=cfg.part_size, mate=mate)
    return n


def _compress_paired(cfg: Config, stats: RunStats, meta: Dict,
                     t0: float) -> RunStats:
    """Paired-end compression: mate 2 follows mate 1's permutation;
    separate ``_1``/``_2`` output triplets (SURVEY.md §2 "Paired-end
    sync")."""
    path1, path2 = cfg.inputs
    block_iter = fastq.iter_paired_blocks(path1, path2, cfg.block_reads,
                                          cfg.max_read_len)
    qual_map, buffered, block_iter = _lossy_preamble(cfg, block_iter)
    enc = BlockEncoder(cfg, qual_map)
    stats.placement = "host" if enc.host_core else "device"
    out_prefix, multihost = _host_output(cfg)
    psize = 0 if multihost else cfg.part_size
    w1 = container.TripletWriter(out_prefix, meta, part_size=psize, mate=1,
                                 resume=cfg.resume)
    w2 = container.TripletWriter(out_prefix, meta, part_size=psize, mate=2,
                                 resume=cfg.resume)
    if cfg.resume and w1.existing_blocks != w2.existing_blocks:
        # asymmetric truncation: the crash split the mates mid-pair
        # (one mate's block became durable, the other's didn't) —
        # re-truncate BOTH outputs to the intersection so the pair-sync
        # invariant holds, then encode onward from there
        common = w1.existing_blocks & w2.existing_blocks
        w1.abort()
        w2.abort()
        w1 = container.TripletWriter(out_prefix, meta, part_size=psize,
                                     mate=1, resume=True, keep_only=common)
        w2 = container.TripletWriter(out_prefix, meta, part_size=psize,
                                     mate=2, resume=True, keep_only=common)
        assert w1.existing_blocks == w2.existing_blocks == common
    from scalce_tpu.parallel.merge import owns_block
    owned = (p for p in itertools.chain(buffered, block_iter)
             if owns_block(p[0].block_id, cfg.host_id, cfg.n_hosts)
             and p[0].block_id not in w1.existing_blocks)

    def emit(pair):
        e1, e2 = pair
        w1.add_block(e1.block_id, e1.payloads, e1.n_reads)
        w2.add_block(e2.block_id, e2.payloads, e2.n_reads)
        stats.n_blocks += 1
        stats.n_reads += e1.n_reads + e2.n_reads
        for k in "nrq":
            stats.stream_bytes[k] += len(e1.payloads[k]) + len(e2.payloads[k])

    def assemble_pair_recycle(p, d):
        # same contract as the single-end branch: assemble_pair is the
        # last reader of both mates' parsed arrays
        out = enc.assemble_pair(p[0], p[1], d)
        fastq.recycle_block(p[0])
        fastq.recycle_block(p[1])
        return out

    if cfg.data_parallel:
        _run_sharded(cfg, _prefetch(owned), qual_map, emit, stats.stage_s,
                     paired=True)
    elif enc.host_core or enc.long_mode:
        _run_pipelined(_prefetch(owned),
                       lambda p: enc.encode_device_pair(*p),
                       assemble_pair_recycle,
                       emit, cfg.threads, stats.stage_s)
    else:
        # device placement: upload both mates one pair ahead (see the
        # single-end branch for why)
        uploaded = ((p, enc.upload(p[0]), enc.upload(p[1]))
                    for p in _prefetch(owned))
        _run_pipelined(
            _prefetch(uploaded, depth=2),
            lambda it: enc.encode_device_pair(*it[0], pre1=it[1],
                                              pre2=it[2]),
            lambda it, d: enc.assemble_pair(it[0][0], it[0][1], d),
            emit, cfg.threads, stats.stage_s)
    w1.close()
    w2.close()
    stats.input_bytes = _file_size(path1) + _file_size(path2)
    stats.output_bytes = sum(stats.stream_bytes.values())
    stats.wall_s = time.monotonic() - t0
    return stats


class _AsyncWriter:
    """Single background writer draining an ordered (file, buffer)
    queue — file writes at disk-writeback speed were ~50 ms of every
    decompressed block's wall; overlapping them with decode costs one
    thread and preserves per-file byte order (emit enqueues in block
    order)."""

    def __init__(self, depth: int = 4):
        self._q: _queue.Queue = _queue.Queue(maxsize=depth)
        self._err: List[BaseException] = []
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            out, buf = item
            try:
                out.write(buf)
            except BaseException as e:     # surfaced on next write/close
                self._err.append(e)

    def write(self, out, buf) -> None:
        if self._err:
            raise self._err[0]
        self._q.put((out, buf))

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err[0]


def _run_decode_pipeline(items: Iterator, decs: List, outs: List,
                         workers: int, stats: RunStats) -> None:
    """Pipelined decompress over one or more channels (mates).

    ``items`` yields per-channel payload tuples, one per block.  Stages:

      worker pool:  payload parse (seq reconstruct + qual fields)
      main thread:  device dispatch of each group's quality decode
      worker pool:  D2H fetch + finish + FASTQ render
      writer thread: ordered writes (overlapped with decode)

    This is the decompress counterpart of ``_run_pipelined`` — the
    reference's ``-T`` concurrency applied to the decode direction
    (SURVEY.md §4.2), which round 1 left single-threaded.
    """
    from scalce_tpu.pipeline.decode import DECODE_GROUP
    C = len(decs)
    pool = _fut.ThreadPoolExecutor(max_workers=max(1, workers))
    parse_pending: collections.deque = collections.deque()
    out_pending: collections.deque = collections.deque()
    name_ctr = [1] * C
    max_parse = max(1, workers) * 2 + DECODE_GROUP

    def render_all(blocks):
        return [fastq.render_fastq_records(b.seq, b.qual, b.lengths,
                                           b.n_reads, b.exc_pos, b.exc_byte,
                                           b.names, b.plus)
                for b in blocks]

    def finish_group(c, plist, parsed_list, dev, starts):
        blocks = decs[c].finish_group(plist, parsed_list, dev, starts)
        return blocks, render_all(blocks)

    def finish_single(c, payloads, parsed_enc, start):
        parsed, enc = parsed_enc
        qual = decs[c].decode_qual_single(enc, parsed[1])
        b = decs[c]._finish(payloads, parsed, qual, start)
        return [b], render_all([b])

    writer = _AsyncWriter()

    def emit(futs):
        for c, f in futs:
            blocks, bufs = f.result()
            for b, buf in zip(blocks, bufs):
                if buf is not None and len(buf):
                    writer.write(outs[c], buf)
                stats.n_reads += b.n_reads
            if c == 0:
                stats.n_blocks += len(blocks)

    def drain(block_all: bool) -> None:
        while out_pending and (block_all or len(out_pending) > 2
                               or out_pending[0][0][1].done()):
            emit(out_pending.popleft())

    def dispatch(group) -> None:
        # group: list of (payload_tuple, parsed_enc_tuple)
        futs = []
        for c in range(C):
            plist = [g[0][c] for g in group]
            pe = [g[1][c] for g in group]
            parsed_list = [x[0] for x in pe]
            starts = []
            for pr in parsed_list:
                starts.append(name_ctr[c])
                name_ctr[c] += pr[2]
            # per-block order auto-selection can mix orders within a
            # group; the batched device decode requires uniform
            # (B, L, T, order) — fall back to per-block decode otherwise
            unif = len({(e.B, e.L, e.T, e.order)
                        for e in (x[1] for x in pe)}) == 1
            if len(group) == DECODE_GROUP and decs[c].qual_on_device and unif:
                dev = decs[c].dispatch_quals(parsed_list,
                                             [x[1] for x in pe])
                futs.append((c, pool.submit(finish_group, c, plist,
                                            parsed_list, dev, starts)))
            else:
                # host placement (or tail group): per-block decode on
                # workers — grouping only exists to batch DEVICE quality
                # scans; on the host path it would serialize the whole
                # group inside one worker
                for p, x, s in zip(plist, pe, starts):
                    futs.append((c, pool.submit(finish_single, c, p, x, s)))
        out_pending.append(futs)
        drain(False)

    def parse_item(ptuple):
        return tuple(decs[c].parse_block(ptuple[c]) for c in range(C))

    try:
        group: List = []
        for ptuple in items:
            parse_pending.append(
                (ptuple, pool.submit(parse_item, ptuple)))
            while len(parse_pending) >= max_parse:
                pt, f = parse_pending.popleft()
                group.append((pt, f.result()))
                if len(group) == DECODE_GROUP:
                    dispatch(group)
                    group = []
        while parse_pending:
            pt, f = parse_pending.popleft()
            group.append((pt, f.result()))
            if len(group) == DECODE_GROUP:
                dispatch(group)
                group = []
        if group:
            dispatch(group)
        drain(True)
    finally:
        pool.shutdown(wait=True)
        writer.close()   # join pending writes; re-raise writer errors


def decompress(cfg: Config) -> RunStats:
    t0 = time.monotonic()
    stats = RunStats(mode="decompress")
    (path,) = cfg.inputs
    reader = container.TripletReader(path)
    meta = reader.meta
    if meta.get("paired"):
        return _decompress_paired(cfg, stats, reader, meta, t0)
    dec = BlockDecoder(meta, keep_order=cfg.keep_order,
                       qual_on_device=cfg.qual_on_device,
                       delta_on_device=cfg.delta_on_device)
    if cfg.output == "-":
        out_path = None
        out_cm = _stdout_cm()
    else:
        out_path = cfg.output if cfg.output.endswith(".fastq") \
            else cfg.output + ".fastq"
        out_cm = open(out_path, "wb")
    with out_cm as out:
        items = ((payloads,) for bid, payloads
                 in _prefetch(reader.iter_blocks(), depth=8))
        _run_decode_pipeline(items, [dec], [out], cfg.threads, stats)
    stats.output_bytes = _file_size(out_path) if out_path else 0
    stats.wall_s = time.monotonic() - t0
    return stats


class _stdout_cm:
    """Context manager handing out the binary stdout without closing it
    (``-o -`` decompression for pipe consumers)."""

    def __enter__(self):
        return sys.stdout.buffer

    def __exit__(self, *exc):
        sys.stdout.buffer.flush()
        return False


def _decompress_paired(cfg: Config, stats: RunStats,
                       reader: container.TripletReader, meta: Dict,
                       t0: float) -> RunStats:
    """Decode both mates in lockstep: record i of ``<out>_1.fastq`` pairs
    with record i of ``<out>_2.fastq`` (the reference's pair-sync
    invariant, SURVEY.md §1 item 6)."""
    prefix = reader.prefix
    r1 = reader if reader.mate == 1 else container.TripletReader(
        container.part_paths(prefix, 0, 1)["r"])
    r2 = container.TripletReader(container.part_paths(prefix, 0, 2)["r"])
    d1 = BlockDecoder(meta, keep_order=cfg.keep_order,
                      qual_on_device=cfg.qual_on_device,
                      delta_on_device=cfg.delta_on_device)
    d2 = BlockDecoder(meta, keep_order=cfg.keep_order,
                      qual_on_device=cfg.qual_on_device,
                      delta_on_device=cfg.delta_on_device)
    out1 = open(f"{cfg.output}_1.fastq", "wb")
    out2 = open(f"{cfg.output}_2.fastq", "wb")
    try:
        def items():
            for (bid1, p1), (bid2, p2) in zip(r1.iter_blocks(),
                                              r2.iter_blocks()):
                if bid1 != bid2:
                    raise ValueError("mate triplets disagree on block order")
                yield (p1, p2)

        _run_decode_pipeline(_prefetch(items(), depth=8), [d1, d2],
                             [out1, out2], cfg.threads, stats)
    finally:
        out1.close()
        out2.close()
    stats.output_bytes = (_file_size(f"{cfg.output}_1.fastq")
                          + _file_size(f"{cfg.output}_2.fastq"))
    stats.wall_s = time.monotonic() - t0
    return stats


def _file_size(path: str) -> int:
    import os
    try:
        return os.path.getsize(path)
    except OSError:
        return 0
