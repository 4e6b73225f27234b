"""Template-anchored initial MSA.

Re-architecture of InitialAligner.c: the per-thread full DP matrices
(IntoAligner, InitialAligner.c:282-453) become batched wavefront DP with
move codes on the accelerator + lockstep host backtracking; Building_MSA
(:553-663) is reproduced exactly, including its two load-bearing quirks:

* Gapcount is accumulated over ALL sequences — also the ones later
  excluded as class 'l' (error >= cutoff) — so garbage alignments of
  flank pieces widen the MSA (loop at :575 has no error filter).
* A leading run of unaligned bases is counted into Gapcount at the
  first aligned base's column (:580-582) but EMITTED at slot 0
  (:617-624); if it exceeds Gapcount[0] the row becomes ragged — which
  downstream readers abort on. Reproduced bit-for-bit (the fallback
  emitter handles the spill).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import InitialAlignerConfig
from ..ops import editdp

GAP = 4


# ---------------------------------------------------------------- banding
#
# Scale path for paper-size datasets: glocal pieces align at UNKNOWN
# template offsets (free template prefix/suffix, InitialAligner.c
# :336-346), so banding needs a per-piece center path. Exact 15-mer
# anchors against the (internally repeat-free) template give the
# offset; the DP then runs in a band around the interpolated anchor
# path. Pieces without anchors (flank garbage, error >= 0.30 ->
# class 'l') get the length-scaled diagonal — banded error can only
# overestimate, so 'l' classification is conservative and their only
# downstream effect is the Gapcount widening quirk.

_KMER = 15


class TemplateIndex:
    """Sorted unique k-mer index of the template."""

    def __init__(self, template: np.ndarray, k: int = _KMER):
        self.k = k
        t = np.asarray(template, np.int64)
        self.tlen = len(t)
        from numpy.lib.stride_tricks import sliding_window_view
        self.pw = (np.int64(4) ** np.arange(k)).astype(np.int64)
        if self.tlen < k:
            self.keys = np.empty(0, np.int64)
            self.order = np.empty(0, np.int64)
            self.uniq = np.empty(0, bool)
            return
        w = sliding_window_view(t, k)
        keys = w @ self.pw
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        uniq = np.ones(len(sk), bool)
        if len(sk) > 1:
            dup = sk[1:] == sk[:-1]
            uniq[1:] &= ~dup
            uniq[:-1] &= ~dup
        self.keys, self.order, self.uniq = sk, order, uniq

    def anchors(self, seq: np.ndarray):
        """(x, j) exact unique k-mer hits at sampled query positions."""
        lq = len(seq)
        k = self.k
        if lq < k or len(self.keys) == 0:
            return None
        from numpy.lib.stride_tricks import sliding_window_view
        w = sliding_window_view(np.asarray(seq, np.int64), k)
        stride = max(1, min(64, lq // 256))
        xs = np.arange(0, lq - k + 1, stride)
        qk = w[xs] @ self.pw
        idx = np.minimum(np.searchsorted(self.keys, qk),
                         len(self.keys) - 1)
        hit = (self.keys[idx] == qk) & self.uniq[idx]
        if hit.sum() < 2:
            return None
        return xs[hit], self.order[idx[hit]]


def anchor_centers(tindex: TemplateIndex, seq: np.ndarray,
                   outlier: int = 3000) -> np.ndarray | None:
    """Monotone band-center path (1-based template cols) for one piece,
    or None when the piece has <2 consistent anchors."""
    a = tindex.anchors(seq)
    if a is None:
        return None
    hx, hj = a
    d = hj.astype(np.int64) - hx
    med = np.median(d)
    keep = np.abs(d - med) <= outlier
    hx, hj = hx[keep], hj[keep]
    if len(hx) < 2:
        return None
    mono = np.maximum.accumulate(hj) == hj
    hx, hj = hx[mono], hj[mono]
    lq = len(seq)
    cen = np.interp(np.arange(lq), hx, hj.astype(np.float64))
    x0, xl = int(hx[0]), int(hx[-1])
    cen[:x0] = hj[0] - (x0 - np.arange(x0))
    cen[xl:] = hj[-1] + (np.arange(lq - xl))
    return np.maximum.accumulate(
        np.clip(np.round(cen) + 1, 1, tindex.tlen)).astype(np.int32)


def scaled_diagonal(lq: int, tlen: int) -> np.ndarray:
    return np.clip(((np.arange(lq) + 1.0) * tlen / max(lq, 1)).astype(
        np.int64), 1, tlen).astype(np.int32)


@dataclass
class InitialMSAResult:
    msa: np.ndarray | None        # int8 [rows_r, width]; None if ragged
    rows: list[np.ndarray]        # every emitted row (class 'r'), int8
    seqclass: list[str]           # 'r'/'l' per input seq
    errors: np.ndarray            # AlignmentError per seq (NaN possible)
    alignments: list[np.ndarray]  # per seq: template col per base or -1
    gapcount: np.ndarray          # int32 [T+1]


def align_all(template: np.ndarray, seqs: list[np.ndarray],
              batch_size: int = 16,
              use_native: bool | None = None,
              codes_budget: int | None = None,
              band: int = 0
              ) -> tuple[list[np.ndarray], np.ndarray]:
    """IntoAligner over all seqs: alignments + error rates.

    use_native=None auto-selects the C++ kernel on the CPU platform
    (same semantics, tested); the device path is used on the GPU.
    codes_budget bounds the [Lq, B, C] device move-code tensor, so the
    block size shrinks for long length buckets (default: 1/16 of the
    card's memory on the GPU, 1 GiB on the CPU). band>0 switches the
    native path to anchored banded DP (the scale path)."""
    tlen = len(template)
    n = len(seqs)
    errors = np.full(n, np.nan)
    alignments: list[np.ndarray] = [np.empty(0, np.int32)] * n

    from .. import platform
    if use_native is None:
        use_native = platform.name() == "cpu"
    if codes_budget is None:
        codes_budget = (platform.device_memory_share(1 / 16)
                        if platform.on_gpu() else 1 << 30)
    if use_native and n:
        from ..utils import native as nat
        tindex = TemplateIndex(template) if band > 0 else None
        done = True
        for lo in range(0, n, 512):
            chunk = seqs[lo:lo + 512]
            lens = np.array([len(s) for s in chunk], np.int32)
            lmax = max(1, int(lens.max()))
            padded = np.full((len(chunk), lmax), 100, np.int8)
            for i, s in enumerate(chunk):
                padded[i, :len(s)] = s
            if band > 0:
                # Anchored pieces (and long anchor-less flank garbage)
                # go banded; SHORT anchor-less pieces get the exact full
                # DP — they are genuinely alignable at unknown offsets
                # (error bursts can strip every 15-mer from a 100-base
                # piece) and full DP is cheap at that length.
                centers = np.ones((len(chunk), lmax), np.int32)
                full_idx = []
                for i, s in enumerate(chunk):
                    cen = anchor_centers(tindex, s)
                    if cen is None:
                        if len(s) <= max(4000, band):
                            full_idx.append(i)
                            continue
                        cen = scaled_diagonal(len(s), tlen)
                    centers[i, :len(s)] = cen
                res = nat.initial_align_banded(
                    template.astype(np.int8), padded, lens, centers,
                    band)
                if res is not None and full_idx:
                    sub = np.array(full_idx)
                    fres = nat.initial_align(
                        template.astype(np.int8), padded[sub],
                        lens[sub])
                    if fres is None:
                        res = None
                    else:
                        res[0][sub] = fres[0]
                        res[1][sub] = fres[1]
            else:
                res = nat.initial_align(template.astype(np.int8),
                                        padded, lens)
            if res is None:
                done = False
                break
            aligned, errs = res
            for i in range(len(chunk)):
                alignments[lo + i] = aligned[i, :lens[i]].copy()
                errors[lo + i] = errs[i]
        if done:
            return alignments, errors
    order = np.argsort([len(s) for s in seqs], kind="stable")
    # Length-sorted batches; pad every batch to fixed bucket shapes so
    # XLA compiles once per bucket, not once per batch.
    def bucket(x: int) -> int:
        b = 256
        while b < x:
            b *= 2
        return b

    # The device move-code tensor is [Lq, B, C] int8; long uncut pieces
    # (reads with no first/last template-part hit stay whole,
    # ReadCutter.c:600-601) can push Lq to read length, so the block
    # size shrinks with Lq*C to bound device memory.
    buckets = np.array([bucket(max(1, len(seqs[i]))) for i in order])
    starts = []
    pos = 0
    while pos < n:
        lq = int(buckets[pos])
        b_eff = int(max(1, min(batch_size,
                               codes_budget // (lq * max(tlen, 1)))))
        end = pos
        while end < n and end - pos < b_eff and buckets[end] == lq:
            end += 1
        starts.append((pos, end, lq, b_eff))
        pos = end
    for lo, hi, lq, b_eff in starts:
        idxs = order[lo:hi]
        lens_real = np.array([len(seqs[i]) for i in idxs], np.int32)
        q = np.full((b_eff, lq), 100, np.int16)
        lens = np.zeros(b_eff, np.int32)
        lens[:len(idxs)] = lens_real
        for r, i in enumerate(idxs):
            q[r, :lens_real[r]] = seqs[i]
        # On-device backtracking: only [B, Lq] alignments and the final
        # rows cross the host<->device boundary, not the move codes.
        aligned, fr = editdp.align_on_device(
            q, lens, template.astype(np.int16))
        aligned = np.asarray(aligned)
        fr = np.asarray(fr)
        for r, i in enumerate(idxs):
            nl = int(lens_real[r])
            if nl == 0:
                errors[i] = np.nan
                alignments[i] = np.empty(0, np.int32)
            else:
                entry = editdp.entry_column(fr[r])
                errors[i] = fr[r, entry] / nl
                alignments[i] = aligned[r, :nl].copy()
    return alignments, errors


def compute_gapcount(alignments: list[np.ndarray],
                     tlen: int) -> np.ndarray:
    """Building_MSA:571-597. Leading runs attribute to the first aligned
    base's column; later runs to (previous col + 1)."""
    gapcount = np.zeros(tlen + 1, np.int64)
    for a in alignments:
        if len(a) == 0:
            continue
        placed = np.nonzero(a >= 0)[0]
        if placed.size == 0:
            raise AssertionError(
                "sequence with no aligned base: reference behavior is "
                "undefined (OOB scan, InitialAligner.c:581)")
        first = placed[0]
        # run lengths between placed bases
        prev_end = -1
        slot = int(a[first])           # leading-run slot
        for p in placed:
            run = p - prev_end - 1
            if run > 0 and run > gapcount[slot]:
                gapcount[slot] = run
            slot = int(a[p]) + 1
            prev_end = p
        run = len(a) - prev_end - 1    # trailing run
        if run > 0 and run > gapcount[slot]:
            gapcount[slot] = run
    return gapcount


def emit_row(seq: np.ndarray, a: np.ndarray, gapcount: np.ndarray,
             tlen: int) -> np.ndarray:
    """Building_MSA:612-641 emission for one class-'r' row (int8 codes;
    4 = '-'). Handles leading-run spill producing a ragged row, exactly
    like the reference."""
    n = len(seq)
    placed = np.nonzero(a >= 0)[0] if n else np.empty(0, np.int64)
    width = int(tlen + 1 + gapcount.sum())
    if n == 0:
        return np.full(width, GAP, np.int8)
    first = int(placed[0]) if placed.size else n
    leading = first  # bases before the first aligned base
    if leading <= gapcount[0]:
        # Common case: fully regular row, vectorized fill.
        out = np.full(width, GAP, np.int8)
        gap_end = np.cumsum(gapcount)          # end of slot i's gap region
        base_pos = gap_end + np.arange(tlen + 1)  # slot i's base cell
        gap_start = base_pos - gapcount
        if placed.size:
            cols = a[placed]
            out[base_pos[cols]] = seq[placed]
            # runs after each placed base -> slot col+1 (or the last
            # pseudo-slot tlen), left-aligned in its gap region
            bounds = np.concatenate([placed, [n]])
            for k in range(placed.size):
                run = int(bounds[k + 1]) - int(placed[k]) - 1
                if run:
                    slot = int(a[placed[k]]) + 1
                    s = gap_start[slot]
                    out[s:s + run] = seq[placed[k] + 1:placed[k] + 1 + run]
        if leading:
            out[0:leading] = seq[:leading]
        return out
    # Spill: literal reference emission (ragged row).
    out = []
    k = 0
    for i in range(tlen + 1):
        count = 0
        while k < n and a[k] == -1:
            out.append(int(seq[k]))
            k += 1
            count += 1
        out.extend([GAP] * max(0, int(gapcount[i]) - count))
        if k < n and a[k] == i:
            out.append(int(seq[k]))
            k += 1
        else:
            out.append(GAP)
    return np.array(out, np.int8)


def build_initial_msa(template: np.ndarray, seqs: list[np.ndarray],
                      cfg: InitialAlignerConfig,
                      batch_size: int = 16,
                      use_native: bool | None = None) -> InitialMSAResult:
    """use_native: as in align_all (None: the platform's route)."""
    tlen = len(template)
    alignments, errors = align_all(template, seqs, batch_size=batch_size,
                                   use_native=use_native, band=cfg.band)
    gapcount = compute_gapcount(
        [a for a in alignments if len(a)], tlen)
    rows: list[np.ndarray] = []
    seqclass: list[str] = []
    for seq, a, err in zip(seqs, alignments, errors):
        if err < cfg.error_cutoff:  # NaN compares False, like C
            seqclass.append("r")
            rows.append(emit_row(np.asarray(seq), a, gapcount, tlen))
        else:
            seqclass.append("l")
    widths = {len(r) for r in rows}
    msa = np.stack(rows).astype(np.int8) if len(widths) == 1 and rows \
        else None
    return InitialMSAResult(msa=msa, rows=rows, seqclass=seqclass,
                            errors=errors, alignments=alignments,
                            gapcount=gapcount.astype(np.int32))


def write_outputs(res: InitialMSAResult, msa_path, seqclass_path) -> None:
    from ..utils import io as rio
    with open(msa_path, "wb") as f:
        for row in res.rows:
            f.write(rio.CODE2BASE[row].tobytes() + b"\n")
    with open(seqclass_path, "w") as f:
        for c in res.seqclass:
            f.write(c + "\n")
