"""Block decode pipeline — the decompress driver.

Mirrors the reference's ``decompress()`` [REF: scalce decompress.c —
UNVERIFIED; SURVEY.md §4.2]: per block, decode the three streams and
re-zip into FASTQ records.  Reads come back in REORDERED order — like
the reference, original order is deliberately not restored
(SURVEY.md §1 item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from scalce_tpu import container
from scalce_tpu.io.fastq import Ragged, lens_to_offsets, reorder_ragged
from scalce_tpu.streams import names as names_stream
from scalce_tpu.streams import qualities, seqs


@dataclasses.dataclass
class DecodedBlock:
    seq: np.ndarray          # uint8 [B, L] 2-bit codes
    qual: np.ndarray         # uint8 [B, L]
    lengths: np.ndarray      # int32 [B]
    n_reads: int
    exc_pos: np.ndarray
    exc_byte: np.ndarray
    names: Ragged
    plus: Optional[Ragged]


#: blocks decoded per vmapped quality scan (see qualities.decode_batch):
#: the scan's cost is per step, so stacking blocks into the lane axis
#: amortizes it (not measured on the GPU)
DECODE_GROUP = 4


class BlockDecoder:
    def __init__(self, meta: Dict, keep_order: bool = False,
                 qual_on_device: bool = False,
                 delta_on_device: bool = False):
        self.meta = meta
        self.keep_order = keep_order
        #: quality-decode placement — a per-run choice, independent of
        #: how the file was produced (the payload format is identical)
        self.qual_on_device = qual_on_device
        #: sequence-delta decode placement: pointer-doubling chain
        #: collapse on device (ops.delta_decode) vs the serial host walk
        self.delta_on_device = delta_on_device
        self._name_counter = 1          # template-mode running index

    # -- pipeline-friendly split (driver threads the host halves):
    # parse_block (host, any thread) -> dispatch_quals (main thread,
    # async device) -> finish_group (host, any thread)

    def parse_block(self, payloads: Dict[str, bytes]):
        """Host payload parse: seq reconstruct + quality stream fields."""
        B = int(self.meta["block_reads"])
        L = int(self.meta["max_read_len"])
        parsed = seqs.parse(payloads["r"], B, L,
                            delta_device=self.delta_on_device)
        enc_q = qualities.parse(payloads["q"])
        return parsed, enc_q

    def dispatch_quals(self, parsed_list, encs):
        """Async device dispatch of the group's quality decode (device
        placement) or a passthrough (host placement decodes in
        finish_group on the worker)."""
        if not self.qual_on_device:
            return encs
        return qualities.decode_batch_dispatch(
            encs, [pr[1] for pr in parsed_list])

    def decode_qual_single(self, enc, lengths):
        if self.qual_on_device:
            return qualities.decode(enc, lengths)
        return qualities.decode_host(enc, lengths)

    def finish_group(self, payload_list, parsed_list, dev,
                     name_starts) -> "list[DecodedBlock]":
        if self.qual_on_device:
            quals = qualities.decode_batch_fetch(dev, len(payload_list))
        else:
            quals = [qualities.decode_host(enc, pr[1])
                     for enc, pr in zip(dev, parsed_list)]
        return [self._finish(p, pr, q, ns)
                for p, pr, q, ns in zip(payload_list, parsed_list, quals,
                                        name_starts)]

    def decode_blocks(self, payload_list):
        """Decode a group of blocks, batching the quality scans."""
        if len(payload_list) != DECODE_GROUP and self.qual_on_device:
            return [self.decode_block(p) for p in payload_list]
        parsed_encs = [self.parse_block(p) for p in payload_list]
        parsed = [pe[0] for pe in parsed_encs]
        encs = [pe[1] for pe in parsed_encs]
        if (self.qual_on_device
                and len({(e.B, e.L, e.T, e.order) for e in encs}) != 1):
            # per-block order auto-selection mixed orders in this group:
            # the batched scan needs uniform shapes — decode per block
            quals = [qualities.decode(e, pr[1])
                     for e, pr in zip(encs, parsed)]
            return [self._finish(p, pr, q)
                    for p, pr, q in zip(payload_list, parsed, quals)]
        if self.qual_on_device:
            quals = qualities.decode_batch(encs, [pr[1] for pr in parsed])
        else:
            quals = [qualities.decode_host(e, pr[1])
                     for e, pr in zip(encs, parsed)]
        return [self._finish(p, pr, q)
                for p, pr, q in zip(payload_list, parsed, quals)]

    def decode_block(self, payloads: Dict[str, bytes]) -> DecodedBlock:
        parsed, enc_q = self.parse_block(payloads)
        qual = self.decode_qual_single(enc_q, parsed[1])
        return self._finish(payloads, parsed, qual)

    def _finish(self, payloads: Dict[str, bytes], parsed,
                qual: np.ndarray,
                name_start: Optional[int] = None) -> DecodedBlock:
        seq, lengths, n_reads, exc_pos, exc_byte, perm, rc = parsed
        L = seq.shape[1]

        if rc.any():
            # flip strand-canonicalized sequences back to input
            # orientation (qualities were never flipped)
            from scalce_tpu import native
            if native.AVAILABLE:
                seq = np.ascontiguousarray(seq)
                native.rc_flip_rows(seq, lengths, rc)
            else:
                col = np.arange(L)[None, :]
                src = lengths[:, None] - 1 - col
                safe = np.maximum(src, 0)
                fseq = np.take_along_axis(seq, safe, axis=1)
                fseq = np.where(src >= 0, 3 - fseq, 0).astype(np.uint8)
                seq = np.where(rc[:, None], fseq, seq)

        na = container.unpack_arrays(payloads["n"])
        n = int(na["n"][0])
        if n != n_reads:
            raise ValueError("stream record-count mismatch")
        if "template" in na:
            lib = self.meta.get("name_lib") or "lib"
            if name_start is None:         # serial path: running counter
                name_start = self._name_counter
                self._name_counter += n
            names = names_stream.template_names(lib, name_start, n)
            names_orig_order = self.keep_order   # template: emit as-is
        else:
            names = names_stream.decode(na["names_blob"].tobytes())
            names_orig_order = True              # stored in original order
        plus: Optional[Ragged] = None
        if "plus_cat" in na:
            plus = Ragged(na["plus_cat"].copy(),
                          lens_to_offsets(na["plus_lens"].astype(np.int64)))

        if self.keep_order:
            # restore arrival order: reordered row i came from perm[i]
            inv = np.zeros(n_reads, np.int64)
            inv[perm] = np.arange(n_reads)
            seq2, qual2 = np.zeros_like(seq), np.zeros_like(qual)
            seq2[:n_reads] = seq[inv]
            qual2[:n_reads] = qual[inv]
            seq, qual = seq2, qual2
            lengths2 = np.zeros_like(lengths)
            lengths2[:n_reads] = lengths[inv]
            lengths = lengths2
            if exc_pos.size:
                rows, cols = exc_pos // L, exc_pos % L
                new_pos = perm[rows] * L + cols
                o = np.argsort(new_pos, kind="stable")
                exc_pos, exc_byte = new_pos[o], exc_byte[o]
            # names/plus are stored in original order already
        else:
            # align original-order names/plus with the reordered reads
            if names_orig_order and "template" not in na:
                names = reorder_ragged(names, perm[:n_reads])
            if plus is not None:
                plus = reorder_ragged(plus, perm[:n_reads])
        return DecodedBlock(seq=seq, qual=qual, lengths=lengths,
                            n_reads=n_reads, exc_pos=exc_pos,
                            exc_byte=exc_byte, names=names, plus=plus)
