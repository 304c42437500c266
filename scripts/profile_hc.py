"""Per-stage timing of the HOST-core (hc) assemble path — the placement
the bench runs.  Single-threaded, one block, repeated; prints ms/stage.
Run with: JAX_PLATFORMS=cpu python scripts/profile_hc.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from scalce_tpu.config import Config
    from scalce_tpu.io import fastq
    from scalce_tpu import native, container
    from scalce_tpu.ops import core_match
    from scalce_tpu.pipeline import encode as enc_mod
    from scalce_tpu.streams import qualities, seqs, names as names_stream
    from scalce_tpu.models import lossy
    from scalce_tpu.utils.synth import synth_fastq
    import tempfile

    B = int(os.environ.get("PROF_BLOCK_READS", 1 << 17))
    cfg = Config(mode="compress", inputs=("x",), block_reads=B,
                 core_on_device=False)
    tmp = tempfile.mkdtemp(prefix="prof_")
    path = os.path.join(tmp, "in.fastq")
    with open(path, "wb") as f:
        f.write(synth_fastq(B, 100, seed=42, genome_len=1_000_000,
                            n_rate=0.001))
    block = next(fastq.iter_blocks(path, cfg.block_reads, cfg.max_read_len))
    Bn, L = block.seq.shape
    n = block.n_reads
    print(f"block {Bn}x{L}, n={n}", flush=True)

    qual_map = lossy.identity_map()
    times = {}

    def t(label, fn, *a, **kw):
        t0 = time.monotonic()
        out = fn(*a, **kw)
        dt = (time.monotonic() - t0) * 1e3
        times[label] = times.get(label, 0.0) + dt
        return out

    REPS = int(os.environ.get("PROF_REPS", 3))
    for rep in range(REPS):
        cores = t("core_match_block", native.core_match_block,
                  block.seq, block.lengths, block.exc_pos, n, cfg.core_k,
                  cfg.dict_seed)
        ck, cp, rc, perm_n = cores
        order_n = perm_n
        perm_np = np.concatenate([perm_n, np.arange(n, Bn, dtype=np.int64)])
        ck_s = ck[order_n]
        cp_s = cp[order_n]
        rc_s = rc[order_n]
        len_n = block.lengths[order_n].astype(np.int64)
        len_s = np.zeros(Bn, np.int32)
        len_s[:n] = len_n
        codes_s = t("gather_orient", native.gather_orient,
                    block.seq, order_n, rc_s, len_n)
        bnd = np.ones(n, np.uint8)
        if n > 1:
            bnd[1:] = ((ck_s[1:] != ck_s[:-1])
                       | (ck_s[1:] == np.uint32(core_match.NO_CORE))
                       ).astype(np.uint8)
        mask_bits, shifts, pred_k, lits = t(
            "delta_match_runs", native.delta_match_runs,
            codes_s, bnd, cp_s, len_n, enc_mod._DELTA_K)
        rc_full = np.zeros(Bn, np.uint8)
        rc_full[:n] = rc_s
        delta_np = {
            "mask_bits": mask_bits, "shifts": shifts, "pred_k": pred_k,
            "rc_bits": np.packbits(rc_full, bitorder="little"),
            "lits": lits, "n_lits": len(lits),
        }
        # quality stream (perm + map fused into the native coder)
        enc_q = t("qual_encode_host", qualities.encode_host, block.qual,
                  np.asarray(len_s), cfg.qual_context_order,
                  T_target=cfg.qual_T_target, qual_map=qual_map,
                  perm=perm_np)
        q_payload = t("qual_payload", qualities.payload, enc_q,
                      backend=cfg.backend)
        # exceptions
        inv = np.empty(Bn, np.int64)
        inv[perm_np] = np.arange(Bn)
        if block.exc_pos.size:
            rows, cols = block.exc_pos // L, block.exc_pos % L
            new_pos = inv[rows] * L + cols
            order_idx = np.argsort(new_pos, kind="stable")
            exc_pos_s = new_pos[order_idx]
            exc_byte_s = block.exc_byte[order_idx]
        else:
            exc_pos_s, exc_byte_s = block.exc_pos, block.exc_byte
        r_payload = t("seqs_payload", seqs.payload, delta_np,
                      np.asarray(len_s), n, exc_pos_s, exc_byte_s,
                      perm_np, backend=cfg.backend)
        # names
        def enc_names():
            blob = names_stream.encode(block.names, n, backend=cfg.backend)
            arrays = {"n": np.asarray([n], np.int64),
                      "names_blob": np.frombuffer(blob, np.uint8)}
            deflate = []
            if block.plus is not None:
                arrays["plus_cat"] = block.plus.cat
                arrays["plus_lens"] = block.plus.lens.astype(np.uint32)
                deflate += ["plus_cat", "plus_lens"]
            return container.pack_arrays(arrays, deflate=deflate,
                                         backend=cfg.backend)
        n_payload = t("names", enc_names)

    tot = sum(times.values())
    raw_mb = (block.lengths[:n].sum() * 2 + sum(len(x) for x in [])) / 1e6
    print(f"--- per-stage ms (avg over {REPS} reps), total {tot/REPS:.1f}")
    for k2, v in sorted(times.items(), key=lambda kv: -kv[1]):
        print(f"{k2:24s} {v/REPS:8.2f} ms  ({100*v/tot:5.1f}%)")
    out_bytes = len(q_payload) + len(r_payload) + len(n_payload)
    print(f"payload bytes: q={len(q_payload)} r={len(r_payload)} "
          f"n={len(n_payload)} total={out_bytes}")


if __name__ == "__main__":
    main()
