"""Cut reads into repeat/flank instances against the template.

Re-architecture of ReadCutter.c: the per-read O(len·readlen) DP matrices
(Occurrence, ReadCutter.c:489-568) become one batched wavefront-DP call
on the accelerator per template part; the occurrence-region scan, the
candidate construction and the greedy cut chain are exact ports of the
reference's (quirky) host logic:

* Only parts 0 and parts-1 are actually mapped ("Otherwise runtime is
  prohibitive", ReadCutter.c:600-601); the stale `pos_count` buffer then
  re-records part 0's positions under indices 1..parts-2
  (ReadCutter.c:599-611) — so the idx==parts-2 / idx==1 candidate loops
  (:701-716) really operate on copies of part 0's positions. Reproduced.
* Occurrence's region merge uses `lastmin`, which only holds the
  previous region's min when exactly one above-cutoff cell separates the
  regions (ReadCutter.c:525-567). Reproduced.
* A region reaching column 1 is never closed, hence never recorded.
* Deliberate deviation: the reference's streaming FASTA reader mangles
  the LAST record (stale readlength, ReadCutter.c:89 early return); we
  process every read correctly. Golden tests exclude the final records.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import ReadCutterConfig
from ..ops import editdp


def occurrence_positions(final_row: np.ndarray, readlen: int,
                         part_len: int, cutoff: int) -> list[int]:
    """ReadCutter.c:489-568 region scan over the last DP row.

    Scans columns readlen-1 .. 1 descending; returns end positions of
    detected occurrences in that (descending) order.
    """
    fr = np.asarray(final_row[:readlen])
    below = fr < cutoff
    positions: list[int] = []
    # Maximal runs of below-cutoff within [1, readlen-1].
    idx = np.arange(1, readlen)
    b = below[1:readlen]
    if b.size == 0:
        return positions
    # Run boundaries.
    change = np.nonzero(np.diff(b.astype(np.int8)))[0]
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change, [b.size - 1]])
    runs = [(int(idx[s]), int(idx[e]))
            for s, e in zip(starts, ends) if b[s]]
    # Process descending (the reference scans i downward); a run whose
    # low end is column 1 is never closed -> never recorded.
    prev_min = None          # min of the region immediately above
    prev_lo = None
    for lo, hi in reversed(runs):
        if lo < 2:
            continue
        seg = fr[lo:hi + 1]
        mn = int(seg.min())
        # ties pick the largest column (descending scan, strict '<')
        einstieg = int(hi - np.argmin(seg[::-1]))
        lastmin = prev_min if (prev_lo is not None
                               and prev_lo - hi == 2) else 100000
        if positions:
            if positions[-1] - einstieg > part_len // 2:
                positions.append(einstieg)
            else:
                if lastmin > mn:
                    positions[-1] = einstieg
        else:
            positions.append(einstieg)
        prev_min = mn
        prev_lo = lo
    return positions


def _candidates(entries: list[tuple[int, int]], parts: int, plen: int,
                readlen: int) -> list[int]:
    """The four candidate loops of ReadCutter.c:659-716, in order."""
    cand: list[int] = []
    for p, idx in entries:
        if idx == parts - 1 and p > plen and readlen - p > plen:
            cand.append(p)
    if parts > 1:
        cand = []
        for p, idx in entries:
            if idx == parts - 1 and p > plen and readlen - p > plen:
                cand.append(p)
        for p, idx in entries:
            if idx == 0 and p - plen > plen and \
                    readlen - (p - plen) > plen:
                cand.append(p - plen)
        for p, idx in entries:
            if idx == parts - 2 and p + plen > plen and \
                    readlen - (p + plen) > plen:
                cand.append(p + plen)
        for p, idx in entries:
            if idx == 1 and p - 2 * plen > plen and \
                    readlen - (p - 2 * plen) > plen:
                cand.append(p - 2 * plen)
    return cand


def _greedy_chain(cand: list[int], tlen: int) -> list[int]:
    """ReadCutter.c:719-742: first cut < 1.5·T, then repeatedly the first
    candidate inside (last + T/2, last + 1.5·T).

    Crucial reference detail: selections are written back INTO the
    candidate array at index Cutting_Number, clobbering candidates that
    may not have been scanned yet — reproduced here.
    """
    cp = list(cand)
    j = len(cp)
    cn = 0
    for i in range(j):
        if cp[i] < tlen + tlen // 2:
            cp[cn] = cp[i]
            cn += 1
            break
    if cn == 0:
        return []
    for _k in range(60):
        for i in range(j):
            if cp[cn - 1] + tlen // 2 < cp[i] < \
                    cp[cn - 1] + tlen + tlen // 2:
                if cn < len(cp):
                    cp[cn] = cp[i]
                else:
                    cp.append(cp[i])
                cn += 1
                break
    return cp[:cn]


@dataclass
class CutResult:
    cutting_points: list[list[int]]   # per read
    pieces: list[np.ndarray]          # all pieces, reads in order
    seqs_per_read: list[int]

    def piece_count(self) -> int:
        return len(self.pieces)


def cut_reads(template: np.ndarray, reads: list[np.ndarray],
              cfg: ReadCutterConfig,
              batch_size: int = 64) -> CutResult:
    """Full ReadCutter behavior over a read set."""
    parts = cfg.parts
    steps = len(template) // parts
    plen = steps + cfg.overlap
    cutoff = int(plen * cfg.error_cutoff)
    tlen = len(template)

    # Template part extraction, with the wrap-around quirk neutralized:
    # beyond the template the reference holds uninitialized bytes that
    # never match a base; sentinel 100 reproduces that.
    ext = np.concatenate(
        [template.astype(np.int16),
         np.full(tlen, 100, np.int16)])
    part_first = ext[0:plen]
    part_last = ext[(parts - 1) * steps:(parts - 1) * steps + plen]

    readlens = np.array([len(r) for r in reads], np.int32)
    lt = max(1, int(readlens.max()))
    n = len(reads)

    # Batched final DP rows: query = part, target = read. Native C++
    # kernel on the CPU platform; device wavefront DP on the GPU.
    from .. import platform
    from ..utils import native as nat
    rows0 = np.empty((n, lt), np.int32)
    rows_last = np.empty((n, lt), np.int32)
    use_native = platform.name() == "cpu" and \
        nat.get_lib() is not None
    if use_native:
        padded = np.full((n, lt), 99, np.int8)
        for j in range(n):
            padded[j, :readlens[j]] = reads[j]
        for part, dst in ((part_first, rows0), (part_last, rows_last)):
            res = nat.occurrence_rows(part.astype(np.int8), padded,
                                      readlens)
            if res is None:
                use_native = False
                break
            dst[:] = res
    if not use_native:
        for lo in range(0, n, batch_size):
            hi = min(n, lo + batch_size)
            tgt = np.full((batch_size, lt), 200, np.int16)
            for j in range(lo, hi):
                tgt[j - lo, :readlens[j]] = reads[j]
            for part, dst in ((part_first, rows0),
                              (part_last, rows_last)):
                q = np.broadcast_to(part[None, :], (batch_size, plen))
                qlens = np.full(batch_size, plen, np.int32)
                dst[lo:hi] = np.asarray(
                    editdp.last_rows(q, qlens, tgt))[:hi - lo]

    cutting_points: list[list[int]] = []
    for j in range(n):
        rl = int(readlens[j])
        pos0 = occurrence_positions(rows0[j], rl, plen, cutoff)
        if parts > 1:
            pos_last = occurrence_positions(rows_last[j], rl, plen,
                                            cutoff)
        else:
            pos_last = pos0
        # Stale-buffer quirk: indices 1..parts-2 all carry pos0.
        entries: list[tuple[int, int]] = []
        for i in range(parts):
            src = pos0 if i < parts - 1 or parts == 1 else pos_last
            entries.extend((p, i) for p in src)
        entries.sort(key=lambda t: t[0])  # ascending by position
        cand = _candidates(entries, parts, plen, rl)
        if parts > 1:
            cutting_points.append(_greedy_chain(cand, tlen))
        else:
            # parts==1: no greedy chain (ReadCutter.c:681); the raw
            # idx==parts-1 candidates are the cuts.
            cutting_points.append(cand)

    pieces: list[np.ndarray] = []
    seqs_per_read: list[int] = []
    for j, read in enumerate(reads):
        cuts = cutting_points[j]
        bounds = [0] + cuts + [len(read)]
        for a, b in zip(bounds[:-1], bounds[1:]):
            pieces.append(np.asarray(read[a:b]))
        seqs_per_read.append(len(cuts) + 1)
    return CutResult(cutting_points, pieces, seqs_per_read)
