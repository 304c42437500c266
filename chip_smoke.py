#!/usr/bin/env python3
"""Smoke run of the compress/decompress path on NVIDIA GPUs, in one process.

    python chip_smoke.py             # phases 1-4 on one GPU
    python chip_smoke.py --chips 4   # only the --data-parallel phase, 4 GPUs

Every phase drives ``scalce_tpu.cli.main`` in this process, so all
phases share one JAX client and one compile cache.  Inputs are made
from seeds by ``scalce_tpu.utils.synth``; nothing is downloaded.

  1. main path, default flags (AUTO placement), single-end: 2,097,152
     reads x 100 bp; multiset and ``--keep-order`` round trips
  2. main path, paired (``-r``): 2 x 1,048,576 mates of 150 bp; pair sync
  3. device-op parity: ``--core-placement device --delta-device
     --qual-device`` triplets against ``--core-placement host`` ones for
     ``--qual-order`` 1, 2 and 3, device vs host decodes, and the exact
     ``udiv_u32_small`` division on the GPU; before it, one full block's
     stage A, stage B and rANS scans are timed with ``block_until_ready``
  4. lossy ``-p 30``: sequences and names exact, every quality within
     30% of its Phred value
  5. (``--chips 4`` only) ``--data-parallel`` triplets, lossless and
     ``-p 30``, against host-placed ones

Each check either holds or raises: the script then exits nonzero and
prints no result line, as it does when JAX's default device is not a
GPU.  The last stdout line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from scalce_tpu import cli  # noqa: E402
from scalce_tpu.utils.synth import synth_fastq, synth_pair  # noqa: E402

SINGLE_READS = 2_097_152       # ~0.5 GB of FASTQ, 8 default blocks
PAIRED_READS = 1_048_576       # per mate, 150 bp
PARITY_READS = 524_288
LOSSY_READS = 1_048_576
LOSSY_PCT = 30
BLOCK = 1 << 18                # the CLI's default --block-reads


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def card_lines() -> list:
    """``name, power.limit`` per card, read by a child that stays off
    JAX (the card's one JAX process is this one)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def run_cli(*argv) -> dict:
    """``cli.main`` in-process with ``--stats-json``; returns the stats."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv] + ["--stats-json"])
    if rc != 0:
        raise SmokeFailure(f"cli.main{argv} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def records(data: bytes) -> list:
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    if len(lines) % 4:
        raise SmokeFailure("FASTQ line count is not a multiple of 4")
    return [b"\n".join(lines[i:i + 4]) for i in range(0, len(lines), 4)]


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def write(path: str, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return path


def triplet(prefix: str) -> bytes:
    """The single-end part-0 triplet's bytes, in a fixed order."""
    from scalce_tpu import container
    paths = container.part_paths(prefix, 0, None)
    return b"".join(read(paths[k]) for k in sorted(paths))


class Smoke:
    def __init__(self, work: str, card: str):
        import jax
        self.jax = jax
        self.work = work
        self.card = card

    def path(self, name: str) -> str:
        return os.path.join(self.work, name)

    def clear(self) -> None:
        for name in os.listdir(self.work):
            os.unlink(self.path(name))

    def peak(self) -> str:
        return ", ".join(
            f"{d.id}: {(d.memory_stats() or {}).get('peak_bytes_in_use')}"
            for d in self.jax.local_devices())

    def phase(self, name: str, fn) -> None:
        print(f"phase {name}", flush=True)
        t0 = time.monotonic()
        fn()
        wall = time.monotonic() - t0
        print(f"phase {name}: wall {wall:.3f} s [{self.card}]; "
              f"peak_bytes_in_use by device {{{self.peak()}}}", flush=True)
        self.clear()

    # -- phase 1 --------------------------------------------------------
    def single_end(self) -> None:
        payload = synth_fastq(SINGLE_READS, 100, seed=42,
                              genome_len=1_000_000, n_rate=0.001)
        inp = write(self.path("in.fastq"), payload)
        st = run_cli(inp, "-o", self.path("c"))
        print(f"  compress: {st}")
        check(st["placement"] == "device",
              f"AUTO placement resolved to {st['placement']!r}")
        check(st["n_reads"] == SINGLE_READS, "every read encoded")
        c = self.path("c.00.scalcen")
        st = run_cli("-d", c, "-o", self.path("d"))
        print(f"  decompress: {st}")
        check(sorted(records(read(self.path("d.fastq"))))
              == sorted(records(payload)),
              f"multiset round trip exact ({SINGLE_READS} records)")
        run_cli("-d", c, "--keep-order", "-o", self.path("k"))
        check(read(self.path("k.fastq")) == payload,
              "--keep-order output byte-identical to the input")

    # -- phase 2 --------------------------------------------------------
    def paired(self) -> None:
        m1, m2 = synth_pair(PAIRED_READS, 150, seed=42,
                            genome_len=1_000_000, n_rate=0.001)
        p1 = write(self.path("in_1.fastq"), m1)
        p2 = write(self.path("in_2.fastq"), m2)
        st = run_cli("-r", p1, p2, "-o", self.path("c"))
        print(f"  compress: {st}")
        check(st["placement"] == "device",
              f"paired placement resolved to {st['placement']!r}")
        st = run_cli("-d", self.path("c.00_1.scalcen"), "-o",
                     self.path("d"))
        print(f"  decompress: {st}")
        got = list(zip(records(read(self.path("d_1.fastq"))),
                       records(read(self.path("d_2.fastq")))))
        check(len(got) == PAIRED_READS, "both mates decode every record")
        check(sorted(got) == sorted(zip(records(m1), records(m2))),
              "pair sync: record i of mate 1 pairs with record i of "
              "mate 2, and the pair multiset round-trips")

    # -- phase 3 --------------------------------------------------------
    def time_block(self) -> None:
        """One full block's device stages and rANS scans, each timed
        after its compile with block_until_ready."""
        jax = self.jax
        import jax.numpy as jnp
        from scalce_tpu.config import Config
        from scalce_tpu.io import fastq
        from scalce_tpu.pipeline import encode as E
        from scalce_tpu.streams import qualities as Q
        inp = write(self.path("t.fastq"),
                    synth_fastq(BLOCK, 100, seed=42, genome_len=1_000_000,
                                n_rate=0.001))
        block = next(fastq.iter_blocks(inp, BLOCK, 128))
        B, L = block.seq.shape
        cfg = Config(mode="compress", inputs=(inp,), max_read_len=L,
                     core_on_device=True, qual_on_device=True,
                     delta_on_device=True, qual_context_order=1)
        enc = E.BlockEncoder(cfg)
        pre = enc.upload(block)
        n = jnp.int32(block.n_reads)
        uni = E.block_is_uniform(block)
        k, seed = cfg.core_k, cfg.dict_seed

        def timed(name, fn, *a, reps=5):
            out = jax.block_until_ready(fn(*a))
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn(*a))
                ts.append(time.perf_counter() - t0)
            print(f"  time {name} (B={B}, L={L}): median "
                  f"{np.median(ts) * 1e3:.3f} ms, min {min(ts) * 1e3:.3f} "
                  f"ms over {reps} [{self.card}]", flush=True)
            return out

        timed("stage A, host-delta jit (default path)",
              lambda: E._device_stage_a_hd(pre["seq"], pre["len"], n,
                                           pre["exc"], enc.rank_lut, k,
                                           seed, uniform=uni))
        a_out = timed("stage A jit", lambda: E._device_stage_a(
            pre["seq"], pre["qual"], pre["len"], n, pre["exc"],
            enc.rank_lut, k, seed, uniform=uni))
        _, sym, ctx, counts = timed(
            "stage B jit (delta + quality histogram)",
            lambda: E._device_stage_b(*a_out[1:], n, None, 1))
        T = Q.pick_T(B, L, cfg.qual_T_target)
        freq, cum = Q._normalize_pass(counts, 1)
        states, packed, wcounts = timed(
            f"rANS encode scan (T={T})",
            lambda: Q._encode_pass(sym, ctx, freq.reshape(-1),
                                   cum.reshape(-1), T))
        eq = Q.finish_encoded(np.asarray(freq), np.asarray(states), packed,
                              np.asarray(wcounts), B, L, T, 1)
        lens = np.asarray(a_out[3])
        ref = Q.encode_host(np.asarray(a_out[2]), lens, order=1,
                            T_target=cfg.qual_T_target)
        check(all(np.array_equal(getattr(eq, f), getattr(ref, f))
                  for f in ("freq", "states", "counts", "words")),
              "timed encode scan equals the native host encoder")
        args = [jnp.asarray(a) for a in Q._decode_batch_args([eq], [lens])]
        qual = timed(f"rANS decode scan (T={T})",
                     lambda: Q._decode_batch_pass(*args, 1, T, B, L))
        check(np.array_equal(np.asarray(qual)[0],
                             Q.decode_host(eq, lens)),
              "timed decode scan equals the native host decoder")

    def udiv_edges(self) -> None:
        """rans.udiv_u32_small is the one float step (two f32 divides
        + a fixup): exact against numpy // and % on the CPU test's
        edge set, eager and jitted, plus a 2^24-pair random sweep."""
        import jax.numpy as jnp
        from scalce_tpu.ops import rans
        rng = np.random.default_rng(0)
        xs = np.concatenate([
            rng.integers(0, 1 << 32, size=20000, dtype=np.uint64),
            np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0xFFFF0000, 4095, 4096]),
        ]).astype(np.uint32)
        fs = np.concatenate([
            rng.integers(1, 4097, size=xs.size - 7, dtype=np.uint64),
            np.array([1, 4096, 3, 4095, 2, 7, 4096]),
        ]).astype(np.uint32)
        sweep = np.random.default_rng(1)
        xb = sweep.integers(0, 1 << 32, size=1 << 24,
                            dtype=np.uint64).astype(np.uint32)
        fb = sweep.integers(1, 4097, size=1 << 24,
                            dtype=np.uint64).astype(np.uint32)
        jit_div = self.jax.jit(rans.udiv_u32_small)
        for name, fn, x, f in (("eager", rans.udiv_u32_small, xs, fs),
                               ("jit", jit_div, xs, fs),
                               ("jit sweep", jit_div, xb, fb)):
            q, r = fn(jnp.asarray(x), jnp.asarray(f))
            x64, f64 = x.astype(np.uint64), f.astype(np.uint64)
            check(np.array_equal(np.asarray(q).astype(np.uint64), x64 // f64)
                  and np.array_equal(np.asarray(r).astype(np.uint64),
                                     x64 % f64),
                  f"udiv_u32_small exact on the GPU ({name}, {x.size} pairs)")

    def parity(self) -> None:
        self.time_block()
        self.udiv_edges()
        payload = synth_fastq(PARITY_READS, 100, seed=7,
                              genome_len=1_000_000, n_rate=0.001)
        inp = write(self.path("p.fastq"), payload)
        for order in (1, 2, 3):
            o = str(order)
            st = run_cli(inp, "-o", self.path(f"dev{o}"), "--core-placement",
                         "device", "--delta-device", "--qual-device",
                         "--qual-order", o)
            check(st["placement"] == "device", f"order {o}: device run")
            st = run_cli(inp, "-o", self.path(f"host{o}"),
                         "--core-placement", "host", "--qual-order", o)
            check(st["placement"] == "host", f"order {o}: host run")
            check(triplet(self.path(f"dev{o}"))
                  == triplet(self.path(f"host{o}")),
                  f"order {o}: device and host triplets byte-identical")
            c = self.path(f"dev{o}.00.scalcen")
            run_cli("-d", c, "--qual-device", "--delta-device", "-o",
                    self.path(f"dd{o}"))
            run_cli("-d", c, "-o", self.path(f"hd{o}"))
            dev_out = read(self.path(f"dd{o}.fastq"))
            check(dev_out == read(self.path(f"hd{o}.fastq")),
                  f"order {o}: device and host decodes byte-identical")
            check(sorted(records(dev_out)) == sorted(records(payload)),
                  f"order {o}: decoded multiset equals the input")

    # -- phase 4 --------------------------------------------------------
    def lossy(self) -> None:
        payload = synth_fastq(LOSSY_READS, 100, seed=3,
                              genome_len=1_000_000, n_rate=0.001)
        inp = write(self.path("l.fastq"), payload)
        st = run_cli(inp, "-o", self.path("c"), "-p", LOSSY_PCT,
                     "--core-placement", "device")
        check(st["placement"] == "device", "lossy run on the device")
        run_cli("-d", self.path("c.00.scalcen"), "--keep-order", "-o",
                self.path("d"))
        src = records(payload)
        got = records(read(self.path("d.fastq")))
        check(len(got) == len(src), "every lossy record decodes")
        a = [r.split(b"\n") for r in src]
        b = [r.split(b"\n") for r in got]
        check(all(x[:3] == y[:3] for x, y in zip(a, b)),
              "names and sequences byte-exact under -p 30")
        qa = np.frombuffer(b"".join(x[3] for x in a), np.uint8)
        qb = np.frombuffer(b"".join(y[3] for y in b), np.uint8)
        check(qa.size == qb.size, "quality lengths unchanged")
        va = qa.astype(np.int64) - 33
        err = np.abs(qb.astype(np.int64) - 33 - va)
        check(bool(np.all(err <= LOSSY_PCT / 100.0 * va)),
              f"every quality within {LOSSY_PCT}% of its Phred value "
              f"(max abs error {int(err.max())}, "
              f"{int((err > 0).sum())} of {err.size} changed)")

    # -- phase 5 --------------------------------------------------------
    def data_parallel(self) -> None:
        from scalce_tpu.config import Config
        from scalce_tpu.parallel.mesh import ShardedEncoder
        payload = synth_fastq(SINGLE_READS, 100, seed=42,
                              genome_len=1_000_000, n_rate=0.001)
        inp = write(self.path("in.fastq"), payload)
        for extra in ((), ("-p", LOSSY_PCT)):
            tag = "lossless" if not extra else f"-p {LOSSY_PCT}"
            st = run_cli(inp, "-o", self.path("dp"), "--data-parallel",
                         *extra)
            print(f"  {tag} --data-parallel: {st}")
            check(st["placement"] == "device", f"{tag}: data-parallel run")
            st = run_cli(inp, "-o", self.path("h"), "--core-placement",
                         "host", *extra)
            check(st["placement"] == "host", f"{tag}: host-placed run")
            check(triplet(self.path("dp")) == triplet(self.path("h")),
                  f"{tag}: --data-parallel triplet byte-identical to the "
                  f"host-placed one")
        senc = ShardedEncoder(Config(mode="compress", inputs=(inp,),
                                     data_parallel=True),
                              np.arange(256, dtype=np.uint8))
        devs = list(senc.mesh.devices.flat)
        print(f"  ShardedEncoder.mesh: axes {senc.mesh.axis_names}, "
              f"devices {devs}, {senc.D} blocks per super-step")
        check(st["n_blocks"] % senc.D == 0,
              f"all {st['n_blocks']} blocks went through the mesh "
              f"({st['n_blocks'] // senc.D} super-steps, no tail group)")
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                 for d in self.jax.local_devices()]
        check(len(devs) == 4 and all(p > 0 for p in peaks),
              f"blocks landed on all four devices (peaks {peaks})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the --data-parallel phase")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default device is "
              f"{d0.platform!r}", file=sys.stderr)
        return 1
    if len(devs) < args.chips:
        print(f"chip_smoke: --chips {args.chips} but JAX sees "
              f"{len(devs)} GPU(s)", file=sys.stderr)
        return 1
    from scalce_tpu import native
    from scalce_tpu.io.backend import DEFAULT_BACKEND
    from scalce_tpu.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    cards = card_lines()
    print(f"jax {jax.__version__}; devices: platform {d0.platform}, "
          f"kind {d0.device_kind!r}, count {len(devs)}")
    for line in cards:
        print(f"nvidia-smi name, power.limit: {line}")
    print(f"compile cache: {cache}; generic byte backend: "
          f"{DEFAULT_BACKEND}; native host library: {native.AVAILABLE}")
    if not native.AVAILABLE:
        raise SmokeFailure("the native host library did not build; the "
                           "host placement the phases compare with needs it")

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        smoke = Smoke(work, cards[0])
        if args.chips == 4:
            smoke.phase("5 --data-parallel over 4 GPUs",
                        smoke.data_parallel)
        else:
            smoke.phase("1 main path, single-end", smoke.single_end)
            smoke.phase("2 main path, paired", smoke.paired)
            smoke.phase("3 device-op parity", smoke.parity)
            smoke.phase("4 lossy -p 30", smoke.lossy)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
