"""scalce_tpu — a GPU-accelerated FASTQ compression framework in JAX.

A from-scratch, accelerator-first re-design of the capabilities of
``sfu-compbio/scalce`` (SCALCE: "boosting sequence compression algorithms
using locally consistent encoding", Hach et al., Bioinformatics 2012).

SCALCE is a CPU-bound, single-node C tool: it reorders FASTQ reads so that
reads sharing a "core" substring become adjacent, splits records into
name/sequence/quality streams, and entropy-codes each stream
[REF: scalce compress.c/reads.c/arithmetic.c — UNVERIFIED, reference mount
empty at build time; see SURVEY.md §0].

scalce_tpu keeps the *capabilities* (reorder-boosted stream-split FASTQ
compression, lossy quality mode, paired-end sync, part splitting, CLI
compatibility) but re-architects every hot path as batched JAX work on
the accelerator (an NVIDIA GPU), with native C host paths for machines
without one:

- LCE tokenization   -> batched rolling 2-bit k-mer ranking on device
                        (``scalce_tpu.ops.core_match``)
- bucket reordering  -> device-wide stable multi-key ``lax.sort``
                        (``scalce_tpu.ops.sort``)
- adaptive arith.    -> two-pass vectorized interleaved rANS with static
  coding                per-block context tables (``scalce_tpu.ops.rans``)
- pthread chunking   -> data-parallel block pipeline over a
                        ``jax.sharding.Mesh`` (``scalce_tpu.parallel``)

Layout:
  io/        host-side FASTQ parse/write, byte-stream backends (zlib/bz2)
  models/    core-substring dictionary, quality context models, lossy
             quantizer model
  ops/       device ops (plain jax.numpy / lax, compiled by XLA)
  pipeline/  jit-compiled block encode/decode pipelines
  parallel/  mesh/sharding, multi-host ordered merge
  utils/     logging, stats
  container  on-disk block container (.scalcen/.scalcer/.scalceq triplets)
  cli        scalce-compatible command line
"""

from scalce_tpu.version import __version__


def compress(cfg):
    """Library entry point: run a compression described by a Config."""
    from scalce_tpu.pipeline import driver
    return driver.compress(cfg)


def decompress(cfg):
    """Library entry point: run a decompression described by a Config."""
    from scalce_tpu.pipeline import driver
    return driver.decompress(cfg)


def __getattr__(name):
    if name == "Config":
        from scalce_tpu.config import Config
        return Config
    raise AttributeError(name)


__all__ = ["__version__", "Config", "compress", "decompress"]
