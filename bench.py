"""Benchmark harness: end-to-end FASTQ encode throughput.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
The headline legs run the host placement; the device legs
(``BENCH_DEVICE``, on by default) run afterwards IN THIS PROCESS, so
one process holds the accelerator, and a device leg that fails fails
the run.

Baseline (measured, not assumed — BASELINE.md): the reference SCALCE is
a single-node C tool whose backend is zlib and whose paper claims it is
FASTER than plain gzip (reordering makes deflate cheaper).  The honest
per-host proxy is therefore measured at bench time: single-thread
zlib-6 over a slice of the same FASTQ, scaled by 1.5x for the paper's
"faster than gzip" claim.  vs_baseline = our GB/s / that proxy.
"""

import json
import os
import sys
import tempfile
import time
import zlib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: paper-claimed speed advantage of reference SCALCE over plain gzip
#: (qualitative "faster than gzip"; 1.5x is a generous reading)
REFERENCE_SPEEDUP_VS_GZIP = 1.5


def _measure_reference_proxy(payload: bytes) -> float:
    """Single-thread zlib-6 GB/s over a slice of the bench input."""
    slice_bytes = payload[: 16 << 20]
    t0 = time.monotonic()
    zlib.compress(slice_bytes, 6)
    dt = time.monotonic() - t0
    return len(slice_bytes) / dt / 1e9


def main() -> None:
    from scalce_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    # 16 blocks: enough for the 3-stage pipeline (parse thread / device
    # dispatch / worker assembly) to reach steady state — at 8 blocks
    # the first block's parse+fill latency still costs ~15% of the wall
    # (measured 0.41 vs 0.47 GB/s at 8 vs 16 blocks)
    n_reads = int(os.environ.get("BENCH_READS", 1 << 21))
    block_reads = int(os.environ.get("BENCH_BLOCK_READS", 1 << 17))
    # placement of the headline legs: EXPLICIT host by default, so they
    # never touch the accelerator; BENCH_PLACEMENT=auto|device times
    # the device placement instead
    placement = os.environ.get("BENCH_PLACEMENT", "host")
    if placement not in ("host", "auto", "device"):
        raise SystemExit(f"BENCH_PLACEMENT={placement!r}: "
                         "want host|auto|device")
    place_kw = {}
    if placement == "host":
        place_kw["core_on_device"] = False
    elif placement == "device":
        place_kw["core_on_device"] = True

    from scalce_tpu.config import Config
    from scalce_tpu.pipeline import driver
    from scalce_tpu.utils.synth import synth_fastq

    # tmpfs when available: the decode leg writes the full FASTQ back
    # out, and on a disk-backed /tmp the PREVIOUS run's dirty-page
    # writeback throttles the next run.  The bench measures the codec.
    # the working set is ~4x the input (FASTQ + compressed triplet +
    # decoded FASTQ + slack); tmpfs is RAM-backed, so fall back to the
    # default tmp dir when /dev/shm can't hold it
    tmp_root = None
    need = 4 * n_reads * 241          # ~241 B per synthetic record
    if os.path.isdir("/dev/shm"):
        try:
            st = os.statvfs("/dev/shm")
            if st.f_bavail * st.f_frsize > need:
                tmp_root = "/dev/shm"
        except OSError:
            pass
    # a disk-throttled run must be distinguishable from a codec
    # regression in the artifact: record which working-set
    # location was used, and the machine load, in the JSON line
    workdir_kind = "tmpfs" if tmp_root else "disk"
    if not tmp_root:
        print("[bench] WARNING: /dev/shm unavailable or too small - "
              "working set on disk; walls will include writeback "
              "stalls", file=sys.stderr, flush=True)
    tmp = tempfile.mkdtemp(prefix="scalce_bench_", dir=tmp_root)
    # tmpfs is RAM: leaked ~1.5GB working sets accumulate across runs
    import atexit
    import shutil
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    path = os.path.join(tmp, "bench.fastq")
    print(f"[bench] generating {n_reads} reads ...", file=sys.stderr,
          flush=True)
    payload = synth_fastq(n_reads, 100, seed=42, genome_len=1_000_000,
                          n_rate=0.001)
    with open(path, "wb") as f:
        f.write(payload)
    input_bytes = len(payload)

    def log(msg):
        print(f"[bench +{time.monotonic() - t_start:.1f}s] {msg}",
              file=sys.stderr, flush=True)

    t_start = time.monotonic()

    def run(in_path: str, out_name: str):
        cfg = Config(mode="compress", inputs=(in_path,),
                     output=os.path.join(tmp, out_name),
                     block_reads=block_reads, **place_kw)
        t0 = time.monotonic()
        stats = driver.compress(cfg)
        return time.monotonic() - t0, stats

    # warm-up on a SMALL file: compiles every jit without paying a
    # full-size run
    warm_path = os.path.join(tmp, "warm.fastq")
    with open(warm_path, "wb") as f:
        f.write(synth_fastq(block_reads, 100, seed=7,
                            genome_len=500_000, n_rate=0.001))
    log("warm-up encode (compiles on cold cache)")
    run(warm_path, "warm")
    log("warm-up slice-width variants")
    from scalce_tpu.pipeline.encode import warm_slice_variants
    warm_slice_variants(Config(mode="compress", inputs=(warm_path,),
                               block_reads=block_reads, **place_kw))
    # best-of-N timed runs: neighbor load on a shared host only ever
    # SLOWS a run, so the minimum wall is the capability estimate; the
    # spread goes to stderr
    n_runs = int(os.environ.get("BENCH_RUNS", 3))
    # when the wall spread exceeds ~10% the host is visibly noisy and
    # best-of-3 under-samples the clean-machine capability: keep
    # running, up to BENCH_MAX_RUNS, until the spread settles or the
    # cap is hit
    max_runs = int(os.environ.get("BENCH_MAX_RUNS", max(6, n_runs)))
    spread_tol = float(os.environ.get("BENCH_SPREAD_TOL", 0.10))
    walls = []

    def settled():
        # convergence of the MINIMUM estimate: stop when the three
        # fastest walls agree within tol.  (The overall max/min spread
        # is monotonically non-decreasing, so it could never re-settle
        # once a noisy run landed.)
        if len(walls) < n_runs:
            return False
        best3 = sorted(walls)[:3]
        return (best3[-1] - best3[0]) / best3[0] <= spread_tol

    for i in range(max_runs):
        if settled():
            break
        log(f"timed encode {i + 1}/{max_runs} (min {n_runs})")
        w, stats = run(path, "bench")
        walls.append(w)
    wall = min(walls)
    wall_median = sorted(walls)[len(walls) // 2]
    log(f"encode walls: {[round(w, 3) for w in walls]}")

    budget = float(os.environ.get("BENCH_TIME_BUDGET", 480))
    dec_wall = 0.0
    if time.monotonic() - t_start < budget:
        # decode throughput (stderr detail; JSON line stays encode-only)
        log("warm-up decode")
        dcfg = Config(mode="decompress",
                      inputs=(os.path.join(tmp, "bench.00.scalcen"),),
                      output=os.path.join(tmp, "dec"),
                      block_reads=block_reads)
        driver.decompress(dcfg)          # warm decode jits
        dec_walls = []
        for i in range(n_runs):
            log(f"timed decode {i + 1}/{n_runs}")
            t0 = time.monotonic()
            driver.decompress(dcfg)
            dec_walls.append(time.monotonic() - t0)
        dec_wall = min(dec_walls)
        log(f"decode walls: {[round(w, 3) for w in dec_walls]}")
    else:
        log("over time budget - skipping decode timing")

    # paired-end leg: the north-star workload is paired (BASELINE.json
    # configs 2-5).  Same placement as the main leg.
    paired_gbps = 0.0
    paired_walls = []
    if os.environ.get("BENCH_PAIRED", "1") != "0" \
            and time.monotonic() - t_start < budget:
        from scalce_tpu.utils.synth import synth_pair
        # default scales with the main leg so the CI-size bench stays
        # CI-sized (full runs use 2 x 1M mates = the BASELINE config)
        pr = int(os.environ.get("BENCH_PAIRED_READS",
                                min(1 << 20, n_reads)))
        log(f"paired leg: generating 2 x {pr} mates")
        m1, m2 = synth_pair(pr, 100, seed=42, genome_len=1_000_000,
                            n_rate=0.001)
        p1 = os.path.join(tmp, "mate_1.fastq")
        p2 = os.path.join(tmp, "mate_2.fastq")
        with open(p1, "wb") as f:
            f.write(m1)
        with open(p2, "wb") as f:
            f.write(m2)
        paired_bytes = len(m1) + len(m2)

        def run_paired():
            cfg = Config(mode="compress", inputs=(p1, p2), paired=True,
                         output=os.path.join(tmp, "paired"),
                         block_reads=block_reads, **place_kw)
            t0 = time.monotonic()
            driver.compress(cfg)
            return time.monotonic() - t0

        log("paired warm-up")
        run_paired()                      # mate-2 jits / pool warm
        for i in range(n_runs):
            log(f"timed paired encode {i + 1}/{n_runs}")
            paired_walls.append(run_paired())
        paired_gbps = paired_bytes / min(paired_walls) / 1e9
        log(f"paired walls: {[round(w, 3) for w in paired_walls]} "
            f"-> {paired_gbps:.4f} GB/s")

    # device-placement legs, in this process after the host legs (the
    # host legs never touch the accelerator, so one process holds it).
    # No try/except: a device leg that fails must fail the bench.
    dev_gbps = 0.0
    dev_walls = []
    dev_dec_gbps = 0.0
    dev_dec_walls = []
    if placement == "host" and os.environ.get("BENCH_DEVICE", "1") != "0":
        dev_reads = int(os.environ.get("BENCH_DEVICE_READS",
                                       8 * block_reads))
        dev_path = os.path.join(tmp, "dev.fastq")
        dev_payload = payload if dev_reads == n_reads else synth_fastq(
            dev_reads, 100, seed=42, genome_len=1_000_000, n_rate=0.001)
        with open(dev_path, "wb") as f:
            f.write(dev_payload)
        log("device-placement encode leg")
        for i in range(4):              # 1 warm-up + 3 timed
            cfg = Config(mode="compress", inputs=(dev_path,),
                         output=os.path.join(tmp, "devout"),
                         block_reads=block_reads, core_on_device=True)
            t0 = time.monotonic()
            driver.compress(cfg)
            dev_walls.append(time.monotonic() - t0)
        dev_walls = dev_walls[1:]
        dev_gbps = len(dev_payload) / min(dev_walls) / 1e9
        log(f"device walls: {[round(w, 3) for w in dev_walls]} "
            f"-> {dev_gbps:.4f} GB/s")
        if dec_wall and os.environ.get("BENCH_DEVICE_DECODE", "1") != "0":
            log("device-placement decode leg (--qual-device)")
            for i in range(4):          # 1 warm-up + 3 timed
                cfg = Config(mode="decompress",
                             inputs=(os.path.join(tmp,
                                                  "bench.00.scalcen"),),
                             output=os.path.join(tmp, "devdec"),
                             block_reads=block_reads, qual_on_device=True)
                t0 = time.monotonic()
                driver.decompress(cfg)
                dev_dec_walls.append(time.monotonic() - t0)
            dev_dec_walls = dev_dec_walls[1:]
            dev_dec_gbps = input_bytes / min(dev_dec_walls) / 1e9
            log(f"device decode walls: "
                f"{[round(w, 3) for w in dev_dec_walls]} "
                f"-> {dev_dec_gbps:.4f} GB/s")
    log("done")

    log("measuring gzip-class reference proxy")
    gzip_gbps = _measure_reference_proxy(payload)
    ref_gbps = gzip_gbps * REFERENCE_SPEEDUP_VS_GZIP

    gbps = input_bytes / wall / 1e9
    result = {
        "metric": "encode_throughput",
        "value": round(gbps, 4),
        "unit": "GB/s",
        "vs_baseline": round(gbps / ref_gbps, 2),
        # run-to-run spread on a shared host is real signal: all walls,
        # not just the best; median alongside best so a noisy artifact
        # is self-describing
        "encode_walls_s": [round(w, 3) for w in walls],
        "encode_median_gbps": round(input_bytes / wall_median / 1e9, 4),
        # provenance of the measurement environment: which working-set
        # location, and how loaded the host was
        "workdir": workdir_kind,
        "loadavg": list(os.getloadavg()),
        "decode_gbps": round(input_bytes / dec_wall / 1e9, 4)
        if dec_wall else None,
        "paired_encode_gbps": round(paired_gbps, 4)
        if paired_gbps else None,
        "paired_encode_walls_s": [round(w, 3) for w in paired_walls],
        "device_decode_gbps": round(dev_dec_gbps, 4)
        if dev_dec_gbps else None,
        "device_decode_walls_s": [round(w, 3) for w in dev_dec_walls],
        "ratio": round(stats.input_bytes / stats.output_bytes, 3),
        # device-placement number; null if the leg was skipped
        "device_encode_gbps": round(dev_gbps, 4) if dev_gbps else None,
        "device_encode_walls_s": [round(w, 3) for w in dev_walls],
        "device_vs_baseline": round(dev_gbps / ref_gbps, 2)
        if dev_gbps else None,
    }
    print(json.dumps(result))
    # secondary detail on stderr for humans
    dec_str = (f"decode {input_bytes/dec_wall/1e9:.4f} GB/s; "
               if dec_wall else "decode skipped; ")
    print(f"[bench] {n_reads} reads, {input_bytes/1e6:.1f} MB in "
          f"{wall:.2f}s; ratio {stats.input_bytes/stats.output_bytes:.2f}x; "
          f"{dec_str}"
          f"host zlib-6 {gzip_gbps:.4f} GB/s -> ref proxy {ref_gbps:.4f}; "
          f"stages {stats.stage_s}; streams {stats.stream_bytes}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
