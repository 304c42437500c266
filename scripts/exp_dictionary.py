"""Dictionary-quality A/B (VERDICT r1 item 8; SURVEY.md §8 "Dictionary
generation"): does any structured core ranking beat the implicit mix32
minimizer on repeat-structured genomes?

Metric: sequence-stream bytes (the only stream bucketing affects) for
dict_mode in {hash, lut, lcp} over three genome classes.  Runs on CPU:

    JAX_PLATFORMS=cpu python scripts/exp_dictionary.py

Results land in EXPERIMENTS.md (committed).
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_genomes(rng):
    """Three genome classes with increasing repeat structure."""
    uniform = rng.integers(0, 4, size=600_000, dtype=np.uint8)
    # tandem repeats: a 5k unit repeated 40x with 1% divergence + flanks
    unit = rng.integers(0, 4, size=5_000, dtype=np.uint8)
    copies = []
    for _ in range(40):
        c = unit.copy()
        mut = rng.random(len(c)) < 0.01
        c[mut] = rng.integers(0, 4, size=int(mut.sum()), dtype=np.uint8)
        copies.append(c)
    repeats = np.concatenate(
        [rng.integers(0, 4, size=100_000, dtype=np.uint8)] + copies
        + [rng.integers(0, 4, size=100_000, dtype=np.uint8)])
    # interspersed: Alu-like 300bp element at 3% divergence, 500 copies
    alu = rng.integers(0, 4, size=300, dtype=np.uint8)
    g = rng.integers(0, 4, size=400_000, dtype=np.uint8)
    pos = rng.integers(0, len(g) - 300, size=500)
    for p in pos:
        c = alu.copy()
        mut = rng.random(300) < 0.03
        c[mut] = rng.integers(0, 4, size=int(mut.sum()), dtype=np.uint8)
        g[p:p + 300] = c
    return {"uniform": uniform, "tandem": repeats, "interspersed": g}


def main():
    from scalce_tpu.config import Config
    from scalce_tpu.pipeline import driver
    from scalce_tpu.utils.synth import synth_fastq

    rng = np.random.default_rng(4242)
    genomes = make_genomes(rng)
    n_reads = 1 << 16
    tmp = tempfile.mkdtemp(prefix="exp_dict_")
    rows = []
    for gname, genome in genomes.items():
        path = os.path.join(tmp, f"{gname}.fastq")
        with open(path, "wb") as f:
            f.write(synth_fastq(n_reads, 100, seed=7, genome=genome,
                                n_rate=0.002, rc_rate=0.4))
        for mode in ("hash", "lut", "lcp"):
            cfg = Config(mode="compress", inputs=(path,),
                         output=os.path.join(tmp, f"{gname}_{mode}"),
                         block_reads=1 << 16, dict_mode=mode)
            stats = driver.compress(cfg)
            rows.append((gname, mode, stats.stream_bytes["r"],
                         stats.output_bytes))
            print(f"{gname:13s} {mode:5s} r={stats.stream_bytes['r']:9d} "
                  f"total={stats.output_bytes:9d}", flush=True)
    print("\n| genome | mode | seq-stream bytes | total bytes |")
    print("|---|---|---|---|")
    for g, m, r, t in rows:
        print(f"| {g} | {m} | {r} | {t} |")


if __name__ == "__main__":
    main()
