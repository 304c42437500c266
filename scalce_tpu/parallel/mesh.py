"""Sharded block pipelines: ``shard_map`` data parallelism.

Design (SURVEY.md §3): reads are sharded into independent fixed-size
blocks; a ``('data',)`` mesh axis carries one block per device per
super-step.  The core dictionary is implicit (a hash — ``bitops.mix32``)
so there is nothing to broadcast; the only genuine collective in the
whole framework is the lossy-quality histogram ``psum`` (all hosts must
derive the same merge table — SURVEY.md §6 "Distributed communication
backend": "histogram all-reduce for shared lossy tables").
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from scalce_tpu.ops import rans
from scalce_tpu.ops.bitops import pack_bases_u32
from scalce_tpu.streams import qualities


def local_mesh(n_devices: Optional[int] = None) -> Mesh:
    # LOCAL devices only: blocks are sharded per host (each host encodes
    # its strided share), so the DP mesh must never include another
    # process's non-addressable devices — jax.devices() would, in a
    # jax.distributed job, and shard_map over it needs global arrays
    # this pipeline deliberately never builds.
    devs = jax.local_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("data",))


def _block_stage1(seq, qual, lengths, n_reads, exc_mask, qual_map,
                  rank_lut, k: int, seed: int, order: int,
                  uniform: bool = False):
    """Single-block encode stage (the body shard_map maps over blocks);
    delegates to the same core as the single-device pipeline.  rank_lut
    is the replicated explicit dictionary (single-entry sentinel selects
    the implicit hash), so --dict-mode behaves identically under
    --data-parallel."""
    from scalce_tpu.pipeline.encode import _encode_core
    return _encode_core(seq, pack_bases_u32(seq, axis=1), qual, lengths,
                        n_reads, exc_mask, qual_map, rank_lut,
                        k, seed, order, uniform=uniform)


def _block_stage_mate2(seq, qual, lengths, n_reads, exc_mask, perm,
                       qual_map, rank_lut, k: int, seed: int, order: int,
                       uniform: bool = False):
    """Mate-2 stage: follow mate 1's permutation (paired-end sync under
    --data-parallel; SURVEY.md §2 "Paired-end sync")."""
    from scalce_tpu.pipeline.encode import _encode_core_mate2
    return _encode_core_mate2(seq, qual, lengths, n_reads, exc_mask,
                              perm, qual_map, rank_lut, k, seed, order,
                              uniform=uniform)


def make_sharded_stage1_nq(mesh: Mesh, k: int, seed: int,
                           uniform: bool = False):
    """Host-quality placement: sharded sequence-side stage (no quality
    upload — the largest H2D transfer stays on the host)."""
    from scalce_tpu.pipeline.encode import _encode_core_nq
    dspec = P("data")
    rspec = P()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(dspec, dspec, dspec, dspec, rspec),
             out_specs=(dspec,) * 3)
    def stage1(seq, lengths, n_reads, exc_mask, rank_lut):
        f = partial(_encode_core_nq, k=k, seed=seed, uniform=uniform)
        return jax.vmap(f, in_axes=(0, 0, 0, 0, None))(
            seq, lengths, n_reads, exc_mask, rank_lut)

    return jax.jit(stage1)


def make_sharded_stage1_hd(mesh: Mesh, k: int, seed: int,
                           uniform: bool = False):
    """Host-delta placement: sharded cores→sort→orient returning each
    block's packed buffer (+ its permutation for mate-2 chaining)."""
    from scalce_tpu.pipeline.encode import _encode_core_hd
    dspec = P("data")
    rspec = P()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(dspec, dspec, dspec, dspec, rspec),
             out_specs=(dspec,) * 2)
    def stage1(seq, lengths, n_reads, exc_mask, rank_lut):
        f = partial(_encode_core_hd, k=k, seed=seed, uniform=uniform)
        return jax.vmap(f, in_axes=(0, 0, 0, 0, None))(
            seq, lengths, n_reads, exc_mask, rank_lut)

    return jax.jit(stage1)


def make_sharded_stage_mate2_hd(mesh: Mesh, k: int, seed: int,
                                uniform: bool = False):
    from scalce_tpu.pipeline.encode import _encode_core_mate2_hd
    dspec = P("data")
    rspec = P()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(dspec, dspec, dspec, dspec, dspec, rspec),
             out_specs=dspec)
    def stage2(seq, lengths, n_reads, exc_mask, perm, rank_lut):
        f = partial(_encode_core_mate2_hd, k=k, seed=seed,
                    uniform=uniform)
        return jax.vmap(f, in_axes=(0, 0, 0, 0, 0, None))(
            seq, lengths, n_reads, exc_mask, perm, rank_lut)

    return jax.jit(stage2)


def make_sharded_stage_mate2_nq(mesh: Mesh, k: int, seed: int,
                                uniform: bool = False):
    from scalce_tpu.pipeline.encode import _encode_core_mate2_nq
    dspec = P("data")
    rspec = P()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(dspec, dspec, dspec, dspec, dspec, rspec),
             out_specs=(dspec,) * 2)
    def stage2(seq, lengths, n_reads, exc_mask, perm, rank_lut):
        f = partial(_encode_core_mate2_nq, k=k, seed=seed,
                    uniform=uniform)
        return jax.vmap(f, in_axes=(0, 0, 0, 0, 0, None))(
            seq, lengths, n_reads, exc_mask, perm, rank_lut)

    return jax.jit(stage2)


def make_sharded_stage_mate2(mesh: Mesh, k: int, seed: int, order: int,
                             uniform: bool = False):
    """jit'd mate-2 stage over stacked blocks sharded on 'data'."""
    dspec = P("data")
    rspec = P()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(dspec,) * 6 + (rspec, rspec),
             out_specs=(dspec,) * 5)
    def stage2(seq, qual, lengths, n_reads, exc_mask, perm, qual_map,
               rank_lut):
        f = partial(_block_stage_mate2, k=k, seed=seed, order=order,
                    uniform=uniform)
        return jax.vmap(f, in_axes=(0, 0, 0, 0, 0, 0, None, None))(
            seq, qual, lengths, n_reads, exc_mask, perm, qual_map,
            rank_lut)

    return jax.jit(stage2)


def make_sharded_stage1(mesh: Mesh, k: int, seed: int, order: int,
                        uniform: bool = False):
    """jit'd stage-1 over stacked blocks ``[D, B, L]`` sharded on 'data'.

    Each device runs its local blocks through the full tokenize→sort→
    reorder→pack→histogram stage with zero cross-device traffic.
    """
    dspec = P("data")
    rspec = P()           # replicated (qual_map, rank_lut)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(dspec, dspec, dspec, dspec, dspec, rspec, rspec),
             out_specs=(dspec,) * 6)
    def stage1(seq, qual, lengths, n_reads, exc_mask, qual_map, rank_lut):
        f = partial(_block_stage1, k=k, seed=seed, order=order,
                    uniform=uniform)
        return jax.vmap(f, in_axes=(0, 0, 0, 0, 0, None, None))(
            seq, qual, lengths, n_reads, exc_mask, qual_map, rank_lut)

    return jax.jit(stage1)


def make_sharded_qual_encode(mesh: Mesh, n_ctx: int, n_syms: int, T: int):
    """jit'd rANS pass B over stacked blocks — per-block tables are
    normalized on device (entropy.device_normalize), matching the
    single-device path bit for bit."""
    from scalce_tpu.models import entropy
    dspec = P("data")

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(dspec,) * 3, out_specs=(dspec,) * 4)
    def encode(sym, ctx, counts):
        def one(sym_b, ctx_b, counts_b):
            freq, cum = entropy.device_normalize(counts_b, n_ctx, n_syms)
            states, words, emits = rans.rans_encode(
                sym_b.reshape(-1), ctx_b.reshape(-1),
                freq.reshape(-1), cum.reshape(-1), n_syms, T)
            packed, wcounts = rans.compact_emissions(words, emits)
            return freq, states, packed, wcounts
        return jax.vmap(one)(sym, ctx, counts)

    return jax.jit(encode)


class ShardedEncoder:
    """Single-host multi-device data-parallel block encoder (config 4:
    "blocks sharded across 1 host").

    Batches ``D = |mesh|`` blocks per super-step: stage 1 and the rANS
    pass run as ONE sharded jit each (one block per device); the host
    builds the D per-block tables in between and assembles payloads per
    block afterwards.  Produces payloads byte-identical to the
    single-device encoder — determinism is per-block, so device count
    never changes output bytes.
    """

    def __init__(self, cfg, qual_map: np.ndarray, mesh: Optional[Mesh] = None,
                 group: Optional[int] = None):
        from scalce_tpu.config import resolve_read_len
        from scalce_tpu.pipeline.encode import BlockEncoder
        from scalce_tpu.streams import qualities as Q
        cfg = resolve_read_len(cfg)    # max_read_len=0 (AUTO) -> width
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else local_mesh()
        # `group` blocks per DEVICE per super-step: vmapping several
        # blocks through one jit amortizes per-op dispatch overhead when
        # that (not bandwidth) is the bottleneck — worth raising on
        # dispatch-bound setups; 1 = one block per device
        if group is None:
            group = 1
        self.group = group
        self.D = self.mesh.devices.size * group
        self._host_delta = False
        # stage jits are built lazily per ``uniform`` flag value (the
        # gather-free orientation specialization) and cached — a run
        # over uniform-length FASTQ compiles only the fast variant
        self._stage_cache = {}
        if cfg.qual_on_device:
            self._mk_stage1 = lambda uni: make_sharded_stage1(
                self.mesh, cfg.core_k, cfg.dict_seed,
                cfg.qual_context_order, uniform=uni)
            self._mk_stage2 = lambda uni: make_sharded_stage_mate2(
                self.mesh, cfg.core_k, cfg.dict_seed,
                cfg.qual_context_order, uniform=uni)
            self._T = Q.pick_T(cfg.block_reads, cfg.max_read_len,
                               cfg.qual_T_target)
            self._qenc = make_sharded_qual_encode(
                self.mesh, Q.n_contexts(cfg.qual_context_order), Q.N_SYMS,
                self._T)
        else:
            from scalce_tpu.pipeline.encode import host_delta_available
            self._host_delta = (not cfg.delta_on_device
                                and host_delta_available())
            if self._host_delta:
                self._mk_stage1 = lambda uni: make_sharded_stage1_hd(
                    self.mesh, cfg.core_k, cfg.dict_seed, uniform=uni)
                self._mk_stage2 = lambda uni: make_sharded_stage_mate2_hd(
                    self.mesh, cfg.core_k, cfg.dict_seed, uniform=uni)
            else:
                self._mk_stage1 = lambda uni: make_sharded_stage1_nq(
                    self.mesh, cfg.core_k, cfg.dict_seed, uniform=uni)
                self._mk_stage2 = lambda uni: make_sharded_stage_mate2_nq(
                    self.mesh, cfg.core_k, cfg.dict_seed, uniform=uni)
        self._fallback = BlockEncoder(cfg, qual_map)
        self._qual_map = jnp.asarray(qual_map)

    def _stage1(self, uniform: bool):
        key = ("s1", uniform)
        if key not in self._stage_cache:
            self._stage_cache[key] = self._mk_stage1(uniform)
        return self._stage_cache[key]

    def _stage2(self, uniform: bool):
        key = ("s2", uniform)
        if key not in self._stage_cache:
            self._stage_cache[key] = self._mk_stage2(uniform)
        return self._stage_cache[key]

    def upload_group(self, blocks):
        """H2D uploads for one full group, runnable one group AHEAD of
        dispatch on a background thread (same overlap the single-device
        driver gets from BlockEncoder.upload).  Returns None for tail
        groups (they take the per-block fallback path)."""
        if len(blocks) != self.D:
            return None
        return self._stack_blocks(blocks,
                                  with_qual=self.cfg.qual_on_device)

    def _stack_blocks(self, blocks, with_qual: bool):
        B, L = blocks[0].seq.shape
        seq = np.stack([b.seq for b in blocks])
        lengths = np.stack([b.lengths for b in blocks])
        n_reads = np.asarray([b.n_reads for b in blocks], np.int32)
        exc = np.zeros((self.D, B, L), bool)
        for d, b in enumerate(blocks):
            exc[d].reshape(-1)[b.exc_pos] = True
        if not with_qual:
            return (jnp.asarray(seq), jnp.asarray(lengths),
                    jnp.asarray(n_reads), jnp.asarray(exc))
        qual = np.stack([b.qual for b in blocks])
        return (jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(lengths),
                jnp.asarray(n_reads), jnp.asarray(exc))

    # -- dispatch/assemble split (same contract as BlockEncoder's):
    # the driver runs dispatches on its main thread and assembles on the
    # worker pool, so the DP path pipelines like the single-device one

    def encode_device(self, blocks, pre=None):
        """Async device dispatch for a full group of D blocks."""
        from scalce_tpu.pipeline.encode import block_is_uniform
        assert len(blocks) == self.D
        uni = all(block_is_uniform(b) for b in blocks)
        if not self.cfg.qual_on_device:
            stacked = pre if pre is not None else \
                self._stack_blocks(blocks, with_qual=False)
            if self._host_delta:
                bufs, perms = self._stage1(uni)(*stacked,
                                                self._fallback.rank_lut)
                try:
                    bufs.copy_to_host_async()
                except (AttributeError, NotImplementedError):
                    pass
                return ("hd", bufs, perms)
            perm, delta, len_s = self._stage1(uni)(*stacked,
                                                   self._fallback.rank_lut)
            return (perm, delta, len_s, None, None, None,
                    None, None, None, None)
        stacked = pre if pre is not None else \
            self._stack_blocks(blocks, with_qual=True)
        perm, delta, len_s, sym, ctx, counts = self._stage1(uni)(
            *stacked, self._qual_map, self._fallback.rank_lut)
        freqs, states, words, wcounts = self._qenc(sym, ctx, counts)
        return (perm, delta, len_s, sym, ctx, counts,
                freqs, states, words, wcounts)

    def assemble(self, blocks, devout):
        from scalce_tpu.streams import qualities as Q
        if isinstance(devout[0], str):     # "hd"/"hd2" markers
            bufs = np.asarray(devout[1])
            if devout[0] == "hd2":         # mate-2: no perm in buffer
                perms = np.asarray(devout[2]).astype(np.int64)
                return [self._fallback._assemble_hd(
                            b, bufs[d], with_perm=False, perm_np=perms[d])
                        for d, b in enumerate(blocks)]
            return [self._fallback._assemble_hd(b, bufs[d])
                    for d, b in enumerate(blocks)]
        (perm, delta, len_s, sym, ctx, counts,
         freqs, states, words, wcounts) = devout
        B, L = blocks[0].seq.shape
        out = []
        for d, b in enumerate(blocks):
            delta_d = {k: v[d] for k, v in delta.items()}
            if freqs is None:
                enc_q = None           # host path built inside _assemble
                sym_d = ctx_d = counts_d = None
            else:
                enc_q = Q.finish_encoded(np.asarray(freqs[d]),
                                         np.asarray(states[d]), words[d],
                                         np.asarray(wcounts[d]), B, L,
                                         self._T,
                                         self.cfg.qual_context_order)
                sym_d, ctx_d, counts_d = sym[d], ctx[d], counts[d]
            out.append(self._fallback._assemble(
                b, np.asarray(perm[d]), delta_d, len_s[d], sym_d,
                ctx_d, counts_d, enc_q=enc_q))
        return out

    def encode_blocks(self, blocks):
        """Encode up to D blocks; returns EncodedBlocks in input order."""
        if len(blocks) < self.D:
            # tail group: per-block path (identical bytes)
            return [self._fallback.encode_block(b) for b in blocks]
        return self.assemble(blocks, self.encode_device(blocks))

    # -- paired-end: mate 1 defines each block's permutation; the
    # mate-2 stage follows it (BASELINE.json configs 2+4 jointly)

    def encode_device_pair(self, pairs, pre1=None, pre2=None):
        from scalce_tpu.pipeline.encode import block_is_uniform
        b1s = [p[0] for p in pairs]
        b2s = [p[1] for p in pairs]
        out1 = self.encode_device(b1s, pre=pre1)
        uni2 = all(block_is_uniform(b) for b in b2s)
        if not self.cfg.qual_on_device:
            stacked2 = pre2 if pre2 is not None else \
                self._stack_blocks(b2s, with_qual=False)
            if self._host_delta:
                perms = out1[2]
                bufs2 = self._stage2(uni2)(*stacked2,
                                           perms.astype(jnp.int32),
                                           self._fallback.rank_lut)
                try:
                    bufs2.copy_to_host_async()
                except (AttributeError, NotImplementedError):
                    pass
                return out1, ("hd2", bufs2, perms)
            perm = out1[0]
            delta2, len2 = self._stage2(uni2)(*stacked2,
                                              perm.astype(jnp.int32),
                                              self._fallback.rank_lut)
            return out1, (perm, delta2, len2, None, None, None,
                          None, None, None, None)
        perm = out1[0]
        stacked2 = pre2 if pre2 is not None else \
            self._stack_blocks(b2s, with_qual=True)
        delta2, len2, sym2, ctx2, counts2 = self._stage2(uni2)(
            *stacked2, perm.astype(jnp.int32), self._qual_map,
            self._fallback.rank_lut)
        freqs2, states2, words2, wcounts2 = self._qenc(sym2, ctx2, counts2)
        out2 = (perm, delta2, len2, sym2, ctx2, counts2,
                freqs2, states2, words2, wcounts2)
        return out1, out2

    def assemble_pair(self, pairs, devout):
        out1, out2 = devout
        eb1 = self.assemble([p[0] for p in pairs], out1)
        eb2 = self.assemble([p[1] for p in pairs], out2)
        return list(zip(eb1, eb2))

    def encode_block_pairs(self, pairs):
        if len(pairs) < self.D:
            return [self._fallback.encode_block_pair(*p) for p in pairs]
        return self.assemble_pair(pairs, self.encode_device_pair(pairs))


def make_lossy_hist_allreduce(mesh: Mesh, n_syms: int):
    """Global quality histogram with a psum over 'data' — every shard
    sees the same totals, so the lossy merge table is identical
    everywhere by construction."""
    dspec = P("data")

    @partial(jax.shard_map, mesh=mesh, in_specs=(dspec, dspec),
             out_specs=P())
    def hist(qual, lengths):
        B = qual.shape[1]
        L = qual.shape[2]
        col = jnp.arange(L, dtype=jnp.int32)[None, None, :]
        valid = col < lengths[:, :, None]
        sym = jnp.clip(qual.astype(jnp.int32) - qualities.QUAL_OFFSET,
                       0, n_syms - 1)
        sym = jnp.where(valid, sym, n_syms)          # padding -> overflow bin
        h = jnp.zeros(n_syms + 1, jnp.int32).at[sym.reshape(-1)].add(1)
        return jax.lax.psum(h[:n_syms], "data")

    return jax.jit(hist)
