"""Sum-of-pairs MSA refinement — the reference's PW_ReAligner bottleneck.

Dense-array re-architecture of PW_ReAligner.c. The linked list of Column
structs becomes an int8[rows, cols] matrix plus an int64[cols, 6] symbol
histogram `counts`; the weighted consensus w_con of the reference is a
derived view:

    nonspace(y) = sum(counts[y, 0:5])
    Score(y, b) = w_con[y][b] = nonspace(y) - counts[y, b]   (b < 5)
    Score(y, 5) = nonspace(y)                                 (coverage)

This module holds the REFERENCE-EXACT serial engine (`RealignEngine`,
Gauss-Seidel row sweeps, used for golden parity and as the semantic
oracle). The batched device path (BatchedRealigner below, the
kernels in ops/banded_realign.py and ops/staircase_realign.py) reuses
this module's bookkeeping.

Key reference semantics reproduced (PW_ReAligner.c):
  * banded DP with band centered on the row's current column path
    (Matrix_Filler :1469-1531); off-band-above reads pay the gap cost
    per skipped column, flat for the last seq position (MatrixOut
    :249-303)
  * column-insertion cost max(Score(y,5), Score(y-1,5)) — quirk Q6
  * backtrack move priority: gap, trailing-space, diagonal, column
    insertion (Backtracker :1334-1454); entry column = min over the
    final row scanned descending (ties -> largest y)
  * Column_Adder neighbor rule: other rows get ' ' next to a coverage
    gap, else '-' (:1299-1317)
  * zero-base columns are deleted before every row realignment (W_Con
    :706-763 via Matrix_Filler :1478)
  * EntAlGapper start/end: leading/trailing '-' -> ' ', then empty
    column removal (:459-645)
  * convergence: first round without improvement of the (mille, uno)
    score pair; best MSA checkpointed every improving round
    (main :1681-1747)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import os

import numpy as np

from ..config import RealignerConfig

HUGE = np.int64(1) << 40


def symbol_counts(msa: np.ndarray) -> np.ndarray:
    """int64[cols, 6] histogram of symbols per column.

    Chunked over rows: full-MSA boolean temporaries are multi-GB at
    paper scale, and this VM provisions fresh pages at ~6 MB/s
    (utils/hostmem.py) — small reused temporaries sidestep that."""
    r, c = msa.shape
    counts = np.zeros((c, 6), np.int64)
    step = max(1, (1 << 24) // max(c, 1))
    for k0 in range(0, r, step):
        m = msa[k0:k0 + step]
        for s in range(6):
            counts[:, s] += (m == s).sum(axis=0)
    return counts


def overall_score_pair(counts: np.ndarray) -> tuple[int, int]:
    """The (scoreMille, scoreUno) pair of OverallScorePrint
    (PW_ReAligner.c:933-963), including its '>1000000' carry quirk.

    Row scores are accumulated per row: sum over nonspace cells of
    Score(col, sym). Equivalently per column: sum_b counts[b] *
    (nonspace - counts[b]) for b in 0..4 — but the carry loop runs per
    ROW, so we reproduce the row accumulation.
    """
    ns = counts[:, 0:5].sum(axis=1)
    # per-column total over all rows
    col_total = (counts[:, 0:5] * (ns[:, None] - counts[:, 0:5])).sum()
    return _carry_pair(int(col_total))


def _carry_pair(total: int) -> tuple[int, int]:
    return total // 1000000, total % 1000000


def row_score(msa: np.ndarray, counts: np.ndarray, k: int) -> int:
    row = msa[k]
    ns = counts[:, 0:5].sum(axis=1)
    m = row < 5
    cols = np.nonzero(m)[0]
    return int((ns[cols] - counts[cols, row[cols]]).sum())


@dataclass
class RealignEngine:
    """Reference-exact serial realigner over dense arrays."""
    msa: np.ndarray                  # int8 [R, C], mutated in place-ish
    bandwidth: int = 1000
    counts: np.ndarray = field(init=False)

    def __post_init__(self):
        from ..utils.hostmem import tune_allocator
        tune_allocator()   # column splices need warm-page reuse
        self.msa = np.ascontiguousarray(self.msa, dtype=np.int8)
        self.counts = symbol_counts(self.msa)

    # ------------------------------------------------------ maintenance

    def ent_al_gapper(self) -> int:
        """EntAlGapper: leading/trailing '-' -> ' ' per row, then drop
        zero-base columns. Returns number of converted cells.

        Chunked over rows: the boolean temporaries are multi-GB at
        paper scale and this VM faults fresh pages at ~6 MB/s
        (utils/hostmem.py) — small reused temporaries sidestep that."""
        msa = self.msa
        r, c = msa.shape
        cols = np.arange(c)[None, :]
        convcnt = np.zeros(c, np.int64)
        total = 0
        step = max(1, (1 << 24) // max(c, 1))
        for k0 in range(0, r, step):
            m = msa[k0:k0 + step]
            base = m < 4
            any_base = base.any(axis=1)
            first = np.where(any_base, base.argmax(axis=1), c)
            # argmax on a negative-stride view hits a slow path; flip
            # into a contiguous buffer first
            rev = np.ascontiguousarray(base[:, ::-1])
            last = np.where(any_base, c - 1 - rev.argmax(axis=1), -1)
            outside = (cols < first[:, None]) | (cols > last[:, None])
            conv = outside & (m == 4)
            m[conv] = 5
            convcnt += conv.sum(axis=0)
            total += int(conv.sum())
        self.counts[:, 4] -= convcnt.astype(self.counts.dtype)
        self.counts[:, 5] += convcnt.astype(self.counts.dtype)
        self._drop_empty_columns()
        return total

    def _drop_empty_columns(self) -> None:
        # counts are maintained incrementally at every call site
        # (validate_counts checks the invariant), so emptiness reads
        # from counts in O(C) instead of scanning the MSA
        keep = self.counts[:, 0:4].sum(axis=1) > 0
        if not keep.all():
            idx = np.flatnonzero(keep)
            self.msa = np.ascontiguousarray(
                np.take(self.msa, idx, axis=1))
            self.counts = np.ascontiguousarray(
                np.take(self.counts, idx, axis=0))

    # ------------------------------------------------------ row realign

    def realign_row(self, k: int) -> int:
        """Matrix_Filler(k) + Backtracker(k). Returns the row's new
        banded-DP score (the reference's return value)."""
        self._drop_empty_columns()          # W_Con
        msa, counts = self.msa, self.counts
        c = msa.shape[1]
        row_old = msa[k].copy()
        basepos = np.nonzero(row_old < 4)[0]        # TheWay: Way[x]
        seq = row_old[basepos].astype(np.int64)     # Seq_Bases
        length = len(basepos)
        # Columns_Downdater + Base_Downdater (before the length check,
        # like the reference: an empty row is removed and stays blank).
        np.subtract.at(counts, (np.arange(c), row_old.astype(np.int64)),
                       1)
        msa[k] = 5
        if length == 0:
            return 0

        ns = counts[:, 0:5].sum(axis=1)
        gapcost = ns - counts[:, 4]                  # Score(y, 4)
        subcost = ns[:, None] - counts[:, 0:4]       # Score(y, base)
        inscost = np.empty(c, np.int64)              # max(S(y,5),S(y-1,5))
        inscost[0] = ns[0]
        if c > 1:
            inscost[1:] = np.maximum(ns[1:], ns[:-1])
        gp = np.concatenate([[0], np.cumsum(gapcost)])  # gp[y+1]=sum<=y

        bw = self.bandwidth
        bh = bw // 2
        anf = np.maximum(0, basepos - bh)
        end = np.minimum(c, anf + bw)

        m = np.full((length, bw), HUGE, np.int64)

        def read_prev(x: int, ys: np.ndarray) -> np.ndarray:
            """MatrixOut(x, ys) for a previous row x (vectorized),
            x >= 0, may include ys == -1 / off-band."""
            a, e = int(anf[x]), int(end[x])
            top = a + bw - 1
            out = np.full(len(ys), HUGE, np.int64)
            inband = (ys >= a) & (ys < e)
            out[inband] = m[x, ys[inband] - a]
            above = ys > top
            if above.any():
                # jump: M[x][top] + sum of gap costs (top, y]
                yy = ys[above]
                out[above] = m[x, bw - 1] + (gp[yy + 1] - gp[top + 1])
            # ys < a (incl. -1) stay HUGE
            return out

        for x in range(length):
            a, e = int(anf[x]), int(end[x])
            ys = np.arange(a, e)
            b = int(seq[x])
            if x == 0:
                # MatrixOut(-1, ·) = 0 for every y (PW_ReAligner.c:256)
                diag = subcost[ys, b]
                ups = inscost[ys].astype(np.int64)
            else:
                diag = read_prev(x - 1, ys - 1) + subcost[ys, b]
                ups = read_prev(x - 1, ys) + inscost[ys]
            ok_ins = (ys > 0) & (ys < c - 1)
            av = np.where(ok_ins, np.minimum(diag, ups), diag)
            # left relaxation: M[y] = min(A[y], M[y-1] + gapcost[y])
            rel = np.minimum.accumulate(av - gp[ys + 1]) + gp[ys + 1]
            m[x, :len(ys)] = rel
            if len(ys) < bw:
                m[x, len(ys):] = HUGE

        return self._backtrack(k, length, basepos, seq, anf,
                               m, gapcost, subcost, inscost, gp)

    def _read_m(self, x, y, length, anf, m, gp):
        """MatrixOut for the backtracker (scalar)."""
        if x == -1:
            return 0
        if y == -1:
            return int(HUGE)
        a = int(anf[x])
        bw = self.bandwidth
        if y - a < 0:
            return int(HUGE)
        if y - a > bw - 1:
            if x == length - 1:
                return int(m[x, bw - 1])
            return int(m[x, bw - 1] + (gp[y + 1] - gp[a + bw]))
        return int(m[x, y - a])

    def _backtrack(self, k, length, basepos, seq, anf, m,
                   gapcost, subcost, inscost, gp) -> int:
        msa, counts = self.msa, self.counts
        c = msa.shape[1]
        bh = self.bandwidth // 2

        def place(y: int, sym: int) -> None:
            counts[y, sym] += 1
            msa[k, y] = sym

        # entry scan (Backtracker :1352-1360)
        x = length - 1
        bound = max(-1, int(basepos[x]) - bh)
        best = self._read_m(x, c - 1, length, anf, m, gp)
        wayin = c - 1
        y = c - 1
        while y > bound:
            v = self._read_m(x, y, length, anf, m, gp)
            if v < best:
                best = v
                wayin = y
            y -= 1
        for y in range(c - 1, wayin, -1):
            place(y, 5)
        y = wayin

        inserts: list[tuple[int, int]] = []  # (logical y, base) pending
        while x > -1 and y > -1:
            mxy = self._read_m(x, y, length, anf, m, gp)
            left = self._read_m(x, y - 1, length, anf, m, gp)
            if mxy == left + int(gapcost[y]):
                place(y, 5 if x == length - 1 else 4)
                y -= 1
            elif mxy == left and x == length - 1:
                place(y, 5)
                y -= 1
            elif mxy == self._read_m(x - 1, y - 1, length, anf, m, gp) \
                    + int(subcost[y, int(seq[x])]):
                place(y, int(seq[x]))
                x -= 1
                y -= 1
            elif y > 0 and mxy == self._read_m(x - 1, y, length, anf,
                                               m, gp) + int(inscost[y]):
                inserts.append((y, int(seq[x])))
                x -= 1
            else:
                raise AssertionError(
                    f"backtrack dead end at x={x} y={y} (row {k})")
        while y > -1:
            place(y, 5)
            y -= 1

        # Apply column insertions. They were discovered right-to-left;
        # all inserts at the same y chain before each other exactly like
        # repeated Column_Adder calls after the same Present_Column.
        # Applying in DISCOVERY order at fixed logical y reproduces the
        # reference: each new column lands directly after y, pushing
        # previously inserted ones right.
        if inserts:
            self._apply_inserts(k, inserts)
        return int(best)

    def _apply_inserts(self, k: int, inserts: list[tuple[int, int]]):
        msa = self.msa
        r = msa.shape[0]
        # Process in discovery order; because inserts were discovered at
        # strictly non-increasing y, inserting at position y+1 never
        # shifts the logical index of a LATER (smaller-y) insert.
        cur = msa
        for (y, base) in inserts:
            col = np.full(r, 4, np.int8)
            if y == cur.shape[1] - 1:
                col[:] = 5                       # after Last_Column
            else:
                nxt = cur[:, y + 1]
                prv = cur[:, y]
                col[(nxt == 5) | (prv == 5)] = 5
            col[k] = base
            cur = _splice_cols(cur, [y + 1], col[None])
        self.msa = cur
        self.counts = symbol_counts(cur)

    # ---------------------------------------------------------- driver

    def overall_pair(self) -> tuple[int, int]:
        self._drop_empty_columns()
        return overall_score_pair(self.counts)


def _splice_cols(arr: np.ndarray, positions, cols) -> np.ndarray:
    """np.insert(arr, positions, cols, axis=1) for ascending positions
    at memcpy speed. numpy's multi-insert goes through a fancy-index
    assignment over every element (~60x slower than slice copies at MSA
    scale — profiled 80 s of a 93 s paper-scale sweep); this splices
    contiguous column segments instead. positions are pre-insertion
    indices into arr (np.insert semantics; ties keep given order);
    cols[i] is the inserted column [R].

    Large batches route through the native one-pass row merge: the
    per-segment slice copy touches one cache line per ~8 useful bytes
    when thousands of inserts land in one flush."""
    r, c = arr.shape
    n = len(positions)
    if n > 64 and arr.dtype == np.int8:
        from ..utils import native as nat
        out = nat.splice_cols(arr, positions, cols)
        if out is not None:
            return out
    out = np.empty((r, c + n), arr.dtype)
    prev = 0
    for i, p in enumerate(positions):
        out[:, prev + i:p + i] = arr[:, prev:p]
        out[:, p + i] = cols[i]
        prev = p
    out[:, prev + n:] = arr[:, prev:]
    return out


def _splice_rows(arr: np.ndarray, positions, rows) -> np.ndarray:
    """np.insert(arr, positions, rows, axis=0) for ascending positions
    at memcpy speed (see _splice_cols)."""
    c = arr.shape[0]
    n = len(positions)
    out = np.empty((c + n,) + arr.shape[1:], arr.dtype)
    prev = 0
    for i, p in enumerate(positions):
        out[prev + i:p + i] = arr[prev:p]
        out[p + i] = rows[i]
        prev = p
    out[prev + n:] = arr[prev:]
    return out


def validate_counts(msa: np.ndarray, counts: np.ndarray) -> None:
    """The W_Con_Checker invariant (PW_ReAligner.c:765-859): the
    incremental histogram must equal a from-scratch recount."""
    fresh = symbol_counts(msa)
    if not np.array_equal(fresh, counts):
        bad = np.nonzero((fresh != counts).any(axis=1))[0]
        raise AssertionError(
            f"count invariant violated at columns {bad[:10].tolist()}")


class BatchedRealigner:
    """Device-backed realigner: banded DP + backtrack on the accelerator
    (ops/banded_realign.py), block-level apply on host.

    block_rows=1 reproduces the serial/reference Gauss-Seidel trajectory
    exactly; larger blocks are block-Jacobi (each row's DP sees the
    sweep-start histogram minus its own contribution), which changes the
    trajectory but keeps the same best-checkpoint convergence contract.
    """

    # staircase drift-slack buckets (window lanes = band + widen*chunk);
    # one compile per bucket actually hit — see _realign_block
    WIDEN_LADDER = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)

    @staticmethod
    def staircase_chunk(bandwidth: int, chunk: int = 256) -> int:
        """The staircase chunk for a band: wide bands take chunk <= 128,
        a bound inherited from an earlier kernel's on-chip memory and
        not yet measured on the GPU; results do not depend on it."""
        return min(chunk, 128) if bandwidth >= 768 else chunk

    @classmethod
    def widest_window(cls, bandwidth: int, chunk: int = 256) -> int:
        """W2 at the top rung of the widen ladder."""
        return bandwidth + cls.WIDEN_LADDER[-1] * cls.staircase_chunk(
            bandwidth, chunk)

    @classmethod
    def cuda_fits(cls, bandwidth: int, chunk: int = 256) -> bool:
        """Whether the CUDA fill takes every window of this band."""
        from ..ops import cuda_fill
        return cls.widest_window(bandwidth, chunk) <= cuda_fill.MAX_W2

    def __init__(self, msa: np.ndarray, bandwidth: int = 1000,
                 block_rows: int = 8, mode: str = "exact",
                 chunk: int = 256, kernel: str = "xla", mesh=None):
        from .. import platform
        from ..utils.hostmem import tune_allocator
        tune_allocator()   # big-MSA splices need warm-page reuse
        if mode not in ("exact", "staircase"):
            raise ValueError(f"unknown realign mode {mode!r}")
        if kernel not in ("xla", "cuda", "native"):
            raise ValueError(f"unknown realign kernel {kernel!r}")
        # mesh mode: block rows sharded over the mesh, counts replicated,
        # count deltas psum'd (parallel/sharded.sharded_block_realign);
        # bit-equal trajectory to the single-device XLA path.
        self.mesh = mesh
        self._mesh_cache: dict = {}
        self.msa = np.ascontiguousarray(msa, dtype=np.int8)
        self.counts = symbol_counts(self.msa)
        self.bandwidth = bandwidth
        self.block_rows = block_rows
        self.mode = mode
        self.chunk = self.staircase_chunk(bandwidth, chunk) \
            if mode == "staircase" else chunk
        if kernel == "cuda" and mode == "staircase" and \
                not self.cuda_fits(bandwidth, chunk):
            from ..ops import cuda_fill
            raise ValueError(
                f"the CUDA fill takes windows up to {cuda_fill.MAX_W2} "
                f"lanes; band {bandwidth} at chunk {self.chunk} reaches "
                f"{self.widest_window(bandwidth, chunk)}: use kernel='xla'")
        self.kernel = kernel
        self._pending: list | None = None   # sweep-deferred inserts
        import os
        # max batched inserts before a mid-sweep flush. A memory knob,
        # not math — but a sweep that crosses it flushes mid-sweep,
        # which changes the block>1 Jacobi trajectory (later blocks of
        # the sweep see the spliced geometry), and the device-resident
        # engine's flush points/drops differ from the host's (see
        # realigner_device._try_sweep). Parity gates that assert
        # host==device trajectories on insert-heavy workloads raise it
        # (RR_FLUSH_CAP) so both paths flush exactly once per sweep.
        self._flush_cap = int(os.environ.get("RR_FLUSH_CAP", "16384"))
        # device memory the codes of one block may take: a quarter of
        # the card's limit on the GPU, 4 GiB of host memory on the CPU
        budget = os.environ.get("RR_DEVICE_HBM_BUDGET")
        self._hbm_budget = int(budget) if budget else (
            platform.device_memory_share(0.25) if platform.on_gpu()
            else 4 << 30)

    def ent_al_gapper(self):
        eng = RealignEngine.__new__(RealignEngine)
        eng.msa = self.msa
        eng.bandwidth = self.bandwidth
        eng.counts = self.counts
        eng.ent_al_gapper()
        self.msa, self.counts = eng.msa, eng.counts

    def _drop_empty(self, min_frac: float = 0.0):
        # a column is empty iff it has no base — read it from the
        # incrementally-maintained counts (O(C)), not the MSA (O(R*C)).
        # min_frac>0 defers the (expensive, full-width) compaction until
        # empties accumulate; empty columns are score-neutral (all-zero
        # counts -> zero DP cost), so deferral only changes the block>1
        # Jacobi trajectory, never the score accounting.
        keep = self.counts[:, 0:4].sum(axis=1) > 0
        n_empty = len(keep) - int(keep.sum())
        if n_empty == 0 or n_empty < min_frac * len(keep):
            return
        idx = np.flatnonzero(keep)
        self.msa = np.ascontiguousarray(np.take(self.msa, idx, axis=1))
        self.counts = np.ascontiguousarray(np.take(self.counts, idx,
                                                   axis=0))

    def overall_pair(self):
        self._drop_empty()
        return overall_score_pair(self.counts)

    # engine-polymorphic accessors: the device-resident subclass keeps
    # the MSA in HBM and overrides these so the main loop never forces
    # a download on its hot path (models/realigner_device.py)
    def best_snapshot(self):
        return self.msa.copy()

    def width(self) -> int:
        return self.msa.shape[1]

    def total_bases(self) -> int:
        return int(self.counts[:, 0:4].sum())

    def validate(self) -> None:
        validate_counts(self.msa, self.counts)

    def respawn(self, msa: np.ndarray, block_rows: int):
        """A fresh engine of the same configuration over `msa` (the
        anneal restart, realign_batched)."""
        return BatchedRealigner(msa, bandwidth=self.bandwidth,
                                block_rows=block_rows, mode=self.mode,
                                kernel=self.kernel, mesh=self.mesh)

    def shrink(self, block_rows: int):
        """Adopt a smaller Jacobi block size in place (the anneal's
        non-restore branch). Engines may return a replacement — the
        device-resident subclass hands small blocks to the host native
        engine, whose per-block cost has no dispatch latency."""
        self.block_rows = block_rows
        return self

    def sweep(self) -> None:
        from ..ops import banded_realign as br
        r = self.msa.shape[0]
        bs = self.block_rows
        if (bs == 1 and self.kernel == "native" and self.mode == "exact"
                and os.environ.get("RR_SERIAL_INDIRECT", "1") != "0"):
            from ..utils import native as nat
            lib = nat.get_lib()
            if lib is not None and hasattr(lib, "realign_block_native"):
                self._pending = None
                self._sweep_serial_indirect(nat)
                return
        # block=1 must drop empty columns and splice inserted ones at
        # every step (reference W_Con frees empty columns before the
        # next row, PW_ReAligner.c:706-763, and Column_Adder splices
        # immediately, 1245-1332). Larger blocks already deviate
        # (Jacobi): freeze the column geometry for the whole sweep and
        # apply all inserts in ONE splice at sweep end — each per-block
        # splice rebuilds the full [R, C] array (2.5 GB at paper
        # scale), so 200+ immediate splices per sweep cost more than
        # the DP itself (utils/hostmem.py for why traffic is precious
        # on this host).
        defer = bs > 1
        self._pending = [] if defer else None
        if defer:
            self._drop_empty(min_frac=0.02)
        import os as _os
        import time as _time
        log_every = int(_os.environ.get("RR_SWEEP_LOG", "0") or 0)
        t_start = _time.perf_counter()
        # Device kernels pad every row in a block to the block's max
        # length (and all lanes run to the padded length bucket), so a
        # block mixing a 30k-base row with 3k-base fragments wastes
        # most of its lanes. Visit rows in descending-length order so
        # blocks are length-homogeneous: same set of rows per sweep,
        # different Gauss-Seidel-across-blocks order (block>1 already
        # deviates from the serial trajectory by design; block 1 keeps
        # the exact reference order). Applied for every kernel so the
        # blocked trajectory stays kernel-independent (tested).
        order = np.arange(r)
        if bs > 1:
            if getattr(self, "_len_order", None) is None:
                # row base counts are realignment-invariant: cache once
                lengths_all = (self.msa < 4).sum(axis=1)
                self._len_order = np.argsort(-lengths_all,
                                             kind="stable")
            order = self._len_order
        for k0 in range(0, r, bs):
            rows = [int(k) for k in order[k0:k0 + bs]]
            if not defer:
                self._drop_empty(min_frac=0.0)
            t0 = _time.perf_counter()
            self._realign_block(rows, br)
            if log_every and (k0 // bs) % log_every == 0:
                print(f"[sweep] block {k0 // bs}/{-(-r // bs)} "
                      f"{_time.perf_counter() - t0:.2f}s "
                      f"elapsed {_time.perf_counter() - t_start:.0f}s "
                      f"pending {len(self._pending or ())}", flush=True)
            # bound the deferred-insert batch: each flush rebuilds the
            # [R, C] array once, and the cols staging array is
            # n_pending x R bytes — an unbounded sweep-long batch at
            # paper scale (~20 inserts/row) would stage multi-GB
            if defer and len(self._pending) >= self._flush_cap:
                self._flush_pending()
        if defer:
            self._flush_pending()
            self._pending = None

    def _flush_pending(self) -> None:
        pend = self._pending
        if not pend:
            return
        self._pending = []
        # reference order at one gap: rows in sweep order, reverse
        # discovery within a row (Column_Adder splice order)
        pend.sort(key=lambda t: (t[0], t[1], -t[2]))
        self._do_inserts([(g, k, b) for g, k, o, b in pend])

    def _sweep_serial_indirect(self, nat) -> None:
        """Serial (reference-order Gauss-Seidel) sweep at block_rows=1
        through the native row DP, with the MSA held in a physically
        over-allocated column store plus a logical->physical column
        index.

        The reference keeps columns in a linked list (PW_ReAligner.c
        W_Con frees empty columns, Column_Adder splices inserted ones
        — both O(1) pointer ops). The dense-array equivalent paid a
        full [R, C] rebuild per splice batch and per compaction; at
        paper scale that is ~2.5 GB of traffic per churned row, and
        near convergence ~all rows churn score-neutrally (insert one
        column, free another), so the serial tail was rebuild-bound at
        ~4x the DP cost. Here a splice is an np.insert into the int64
        column-order array (O(C)) plus one O(R) column write into a
        free physical slot, and an empty-column drop is the same in
        reverse. Per-row DP inputs are gathered through the index, so
        results, trajectory, and the final MSA are bit-identical to
        the direct block-1 path (oracle asserts in
        tests/test_batched_realigner.py)."""
        import time as _time
        msa, counts = self.msa, self.counts
        r, c = msa.shape
        bw = self.bandwidth
        slack = max(4096, c // 8)
        phys = np.empty((r, c + slack), np.int8)
        phys[:, :c] = msa
        phys[:, c:] = 5
        cphys = np.zeros((c + slack, 6), np.int32)
        cphys[:c] = counts
        l2p = np.arange(c, dtype=np.int64)
        free = list(range(c, c + slack))
        log_every = int(os.environ.get("RR_SWEEP_LOG", "0") or 0)
        t_start = _time.perf_counter()
        for k in range(r):
            # W_Con: free empty columns before every row (counts-read)
            cl = cphys[l2p]
            keep = (cl[:, 0] | cl[:, 1] | cl[:, 2] | cl[:, 3]) > 0
            if not keep.all():
                free.extend(l2p[~keep].tolist())
                l2p = l2p[keep]
                cl = np.ascontiguousarray(cl[keep])
            cc = len(l2p)
            row_old = phys[k, l2p]
            pos = np.nonzero(row_old < 4)[0]
            ln = len(pos)
            if ln:
                way = np.ascontiguousarray(pos[None, :], np.int32)
                seq = np.ascontiguousarray(row_old[pos][None, :])
                lens = np.array([ln], np.int32)
                cap = 512
                while True:
                    res = nat.realign_block(cl, row_old[None], seq,
                                            way, lens, bw, ins_cap=cap)
                    new_rows, _, iy, ib, inn = res
                    if int(inn[0]) < cap:
                        break
                    cap = max(cap * 2, int(inn[0]) + 1)
                new = new_rows[0]
            else:
                new = np.full(cc, 5, np.int8)
                iy = ib = None
                inn = np.zeros(1, np.int32)
            d = np.nonzero(row_old != new)[0]
            if len(d):
                pd = l2p[d]
                cphys[pd, row_old[d].astype(np.int64)] -= 1
                cphys[pd, new[d].astype(np.int64)] += 1
                phys[k, pd] = new[d]
            n = int(inn[0])
            if n:
                if len(free) < n:
                    # physical capacity exhausted: compact + regrow
                    grow = max(4096, cc // 8) + n
                    ph2 = np.empty((r, cc + grow), np.int8)
                    ph2[:, :cc] = phys[:, l2p]
                    ph2[:, cc:] = 5
                    c2 = np.zeros((cc + grow, 6), np.int32)
                    c2[:cc] = cphys[l2p]
                    phys, cphys = ph2, c2
                    l2p = np.arange(cc, dtype=np.int64)
                    free = list(range(cc, cc + grow))
                # reference order at one gap: reverse discovery within
                # the row (Column_Adder splice order); fills for the
                # whole batch are computed against the pre-splice MSA
                # (free slots are invisible through l2p until spliced)
                order = sorted(range(n),
                               key=lambda o: (int(iy[0, o]), -o))
                gaps = np.array([int(iy[0, o]) for o in order],
                                np.int64)
                slots = np.array([free.pop() for _ in range(n)],
                                 np.int64)
                for i in range(n):
                    g = int(gaps[i])
                    p = int(slots[i])
                    if g == cc - 1:
                        phys[:, p] = 5
                    else:
                        nxt = phys[:, l2p[g + 1]]
                        prv = phys[:, l2p[g]]
                        col = np.full(r, 4, np.int8)
                        col[(nxt == 5) | (prv == 5)] = 5
                        phys[:, p] = col
                    phys[k, p] = ib[0, order[i]]
                    cnt = np.bincount(phys[:, p], minlength=6)
                    cphys[p] = cnt[:6]
                l2p = np.insert(l2p, gaps + 1, slots)
            if log_every and k % (log_every * 64) == 0:
                print(f"[sweep] row {k}/{r} "
                      f"elapsed {_time.perf_counter() - t_start:.0f}s "
                      f"cols {len(l2p)} free {len(free)}", flush=True)
        self.msa = np.ascontiguousarray(phys[:, l2p])
        self.counts = np.ascontiguousarray(cphys[l2p])

    def _realign_block(self, rows: list[int], br) -> None:
        msa, counts = self.msa, self.counts
        c = msa.shape[1]
        bs = len(rows)
        rows_old = msa[rows]                          # [B, C] snapshot
        lengths = np.zeros(bs, np.int32)
        seq_list, way_list = [], []
        for b, k in enumerate(rows):
            pos = np.nonzero(rows_old[b] < 4)[0]
            lengths[b] = len(pos)
            way_list.append(pos.astype(np.int32))
            seq_list.append(rows_old[b][pos])
        lmax = max(1, int(lengths.max()))

        # pad L and C to buckets so XLA compiles once per bucket combo.
        # Power-of-two buckets pay up to 2x: the kernels run every lane
        # to lpad and the block transfers/row buffers scale with cpad,
        # so both get intermediate rungs (bounded extra compiles —
        # shapes repeat across blocks and sweeps, and the persistent
        # compilation cache carries them across runs).
        def bucket(x, base=256, steps=(0.75,)):
            v = base
            while v < x:
                v *= 2
            if v > base:
                for f in sorted(steps):
                    if v * f >= x:
                        return int(v * f)
            return v

        lpad = bucket(lmax)
        cpad = bucket(c, 512, steps=(0.625, 0.75, 0.875))
        seqs = np.zeros((bs, lpad), np.int8)
        ways = np.zeros((bs, lpad), np.int32)
        for b in range(bs):
            seqs[b, :lengths[b]] = seq_list[b]
            ways[b, :lengths[b]] = way_list[b]
            if lengths[b] and lengths[b] < lpad:
                ways[b, lengths[b]:] = way_list[b][-1]

        use_stair = self.mode == "staircase"
        widen = 1
        if use_stair:
            # measure the column-path drift per chunk: the staircase
            # window [a, a + W + widen*T) covers every reference band in
            # the chunk iff drift <= widen*T. Early-round gap-dense MSAs
            # drift ~2 cols/base; compacted ones ~1; full paper-scale
            # MSAs sit near 4-5 (insert-column density), and short
            # fragments spread across sparse spans can exceed any fixed
            # slack. Bucket widen to a short ladder so XLA compiles once
            # per bucket; a finer ladder than powers of two matters at
            # paper scale, where drift sits tightly near 4.6*T (MSA
            # width / row chars) and widen 5 fills 19% fewer window
            # lanes than widen 8. Beyond the cap, fall back to the
            # exact banded fill for this block (gather-based,
            # drift-proof) instead of silently truncating the band.
            t = self.chunk
            starts = np.arange(0, ways.shape[1], t)
            ends = np.minimum(starts + t - 1, ways.shape[1] - 1)
            drift = int((ways[:, ends] - ways[:, starts]).max()) \
                if len(starts) else 0
            widen = next((v for v in self.WIDEN_LADDER
                          if v * t >= drift), 0)
            if not widen:
                use_stair = False
                widen = 1

        # mesh blocks always realign through the device kernels (the
        # mesh branch maps kernel="native" to the XLA fill), so the
        # budget applies to them regardless of the kernel label
        if (self.kernel in ("cuda", "xla")
                or self.mesh is not None) and bs > 8:
            # bound device memory by the codes footprint. The staircase
            # fills emit 2-bit packed time-major codes (lpad*bs*w2/4
            # bytes, no transposed copy) plus the walk's move stream —
            # budget factor 1/2 with headroom. The exact-band fill
            # materializes unpacked [B, L, W] codes plus scan buffers —
            # factor 2. Halve the block until it fits;
            # smaller Jacobi blocks keep the same convergence contract
            # (block>1 already deviates from the serial trajectory by
            # design). The bound uses the widen actually chosen for
            # THIS block (not the ladder cap): the backtrack
            # while_loop's trip count is independent of block rows, so
            # every halving avoided halves its per-sweep cost.
            w2max = (self.bandwidth + widen * self.chunk
                     if use_stair else self.bandwidth)
            factor = 0.5 if use_stair else 2.0
            # on a mesh the block is row-sharded: each device holds
            # bs/n rows of the codes tensor, so the budget bounds the
            # per-shard footprint (the counts/delta replicas are small)
            nshard = int(self.mesh.devices.size) if self.mesh is not None \
                else 1
            if factor * lpad * (bs / nshard) * w2max > self._hbm_budget:
                h = (bs // 2 + 7) // 8 * 8
                self._realign_block(rows[:h], br)
                self._realign_block(rows[h:], br)
                return
        if self.mesh is not None:
            self._realign_block_mesh(rows, rows_old, lengths, seqs,
                                     ways, c, cpad, br, use_stair, widen)
            return
        if self.kernel == "native" and self.mode == "exact":
            from ..utils import native as nat
            cap = 512
            while True:
                res = nat.realign_block(counts.astype(np.int32),
                                        rows_old, seqs, ways, lengths,
                                        self.bandwidth, ins_cap=cap)
                if res is None:
                    break
                new_rows, best, iy, ib, inn = res
                if (inn >= cap).any():
                    cap = max(cap * 2, int(inn.max()) + 1)
                    continue
                self._apply_block(rows, rows_old, new_rows, iy, ib,
                                  inn)
                return

        # upload counts as int16 when they fit (values <= rows): halves
        # the per-block counts transfer; every device kernel casts its
        # cost arrays to int32 on entry
        cdt = np.int16 if self.msa.shape[0] < (1 << 15) else np.int32
        counts_p = np.zeros((cpad, 6), cdt)
        counts_p[:c] = counts
        rows_p = np.full((bs, cpad), 5, np.int8)
        rows_p[:, :c] = rows_old

        bh = self.bandwidth // 2
        last_way = ways[np.arange(len(lengths)),
                        np.maximum(lengths - 1, 0)]
        entry_bound = np.maximum(-1, last_way - bh).astype(np.int32)
        if use_stair:
            from ..ops import staircase_realign as sr
            w_codes = self.bandwidth + widen * self.chunk
            fill = sr.fill_for(self.kernel)
            codes, fband, fanf = fill(
                counts_p, rows_p, seqs, ways, lengths, np.int32(c),
                bandwidth=self.bandwidth, chunk=self.chunk, widen=widen)
            anf_full = sr.staircase_anf(ways, lengths, self.bandwidth,
                                        self.chunk, c)
            new_rows, best, iy, ib, inn = sr.entry_and_walk(
                codes, fband, fanf, seqs, anf_full, entry_bound,
                lengths, np.int32(c), cpad=cpad, bandwidth=w_codes,
                chunk=self.chunk)
        else:
            codes, fband, fanf = br.banded_fill(
                counts_p, rows_p, seqs, ways, lengths, np.int32(c),
                bandwidth=self.bandwidth)
            anf_full = np.maximum(0, ways - bh).astype(np.int32)
            new_rows, best, iy, ib, inn = br.entry_and_backtrack(
                codes, fband, fanf, seqs, anf_full, entry_bound,
                lengths, np.int32(c), cpad=cpad,
                bandwidth=self.bandwidth)
        new_rows = np.asarray(new_rows)[:bs, :c]
        iy = np.asarray(iy)[:bs]
        ib = np.asarray(ib)[:bs]
        inn = np.asarray(inn)[:bs]
        if (inn >= br.MAX_INSERTS).any():
            raise RuntimeError("insert buffer overflow; raise "
                               "MAX_INSERTS or use the serial engine")
        self._apply_block(rows, rows_old, new_rows, iy, ib, inn)

    def _realign_block_mesh(self, rows, rows_old, lengths, seqs, ways,
                            c, cpad, br, use_stair, widen):
        """Mesh-sharded block step: rows data-parallel over the mesh
        'rows' axis, counts replicated, count delta psum'd on device
        (parallel/sharded.sharded_block_realign). Blocks are padded to
        a mesh multiple with duplicates of row 0 whose outputs are
        discarded and whose delta contribution is masked out, so the
        trajectory is bit-equal to the single-device path. use_stair /
        widen: _realign_block's choice for this block (a drift beyond
        every ladder rung takes the exact band)."""
        counts = self.counts
        bs = len(rows)
        n = int(self.mesh.devices.size)
        mode = "staircase" if use_stair else "exact"
        bpad = -(-bs // n) * n
        if bpad != bs:
            p = bpad - bs
            rows_old = np.concatenate(
                [rows_old, np.repeat(rows_old[:1], p, axis=0)])
            seqs = np.concatenate([seqs, np.repeat(seqs[:1], p, axis=0)])
            ways = np.concatenate([ways, np.repeat(ways[:1], p, axis=0)])
            lengths = np.concatenate([lengths,
                                      np.repeat(lengths[:1], p)])
        cdt = np.int16 if self.msa.shape[0] < (1 << 15) else np.int32
        counts_p = np.zeros((cpad, 6), cdt)
        counts_p[:c] = counts
        rows_p = np.full((bpad, cpad), 5, np.int8)
        rows_p[:, :c] = rows_old
        bh = self.bandwidth // 2
        if use_stair:
            from ..ops import staircase_realign as sr
            anf_full = sr.staircase_anf(ways, lengths, self.bandwidth,
                                        self.chunk, c)
        else:
            anf_full = np.maximum(0, ways - bh).astype(np.int32)
        last_way = ways[np.arange(bpad), np.maximum(lengths - 1, 0)]
        entry_bound = np.maximum(-1, last_way - bh).astype(np.int32)
        valid = np.zeros(bpad, np.int32)
        valid[:bs] = 1
        key = (mode, widen)
        step = self._mesh_cache.get(key)
        if step is None:
            from ..parallel import sharded
            step = sharded.sharded_block_realign(
                self.mesh, self.bandwidth, mode=mode,
                chunk=self.chunk, widen=widen, kernel=self.kernel)
            self._mesh_cache[key] = step
        new_rows, iy, ib, inn, delta = step(
            counts_p, rows_p, seqs, ways, lengths, anf_full,
            entry_bound, valid, np.int32(c))
        new_rows = np.asarray(new_rows)[:bs, :c]
        iy = np.asarray(iy)[:bs]
        ib = np.asarray(ib)[:bs]
        inn = np.asarray(inn)[:bs]
        if (inn >= br.MAX_INSERTS).any():
            raise RuntimeError("insert buffer overflow; raise "
                               "MAX_INSERTS or use the serial engine")
        self._apply_block(rows, rows_old[:bs, :c], new_rows, iy, ib,
                          inn, delta=np.asarray(delta)[:c])

    def _apply_block(self, rows, rows_old, new_rows, iy, ib, inn,
                     delta=None):
        """Replace rows, update counts incrementally, splice inserted
        columns (each its own column, reference semantics; fills use
        the post-placement neighbor rule, which for chained same-gap
        inserts equals the reference's chained rule).

        delta: optional precomputed [C, 6] count delta for the row
        substitutions (the mesh path's psum over devices) — replaces
        the per-row host scatter with one vector add."""
        msa, counts = self.msa, self.counts
        c = msa.shape[1]
        if delta is not None:
            counts += delta
            msa[rows] = new_rows
        else:
            # one bincount over (col, sym) pairs per block instead of
            # per-row np.ufunc.at scatters: early rounds change most of
            # every row (~10^5 positions x block), and ufunc.at is
            # ~50x slower than bincount at that size
            old_idx, new_idx = [], []
            for b, k in enumerate(rows):
                old = msa[k]
                new = new_rows[b]
                d = np.nonzero(old != new)[0]
                old_idx.append(d * 6 + old[d])
                new_idx.append(d * 6 + new[d])
                msa[k] = new
            c6 = counts.shape[0] * 6
            sub = np.bincount(np.concatenate(old_idx), minlength=c6)
            add = np.bincount(np.concatenate(new_idx), minlength=c6)
            counts += (add - sub).reshape(-1, 6)
        all_ins = []  # (gap, row, discovery order, base)
        for b, k in enumerate(rows):
            n = int(inn[b])
            for o in range(n):
                all_ins.append((int(iy[b, o]), k, o, int(ib[b, o])))
        if not all_ins:
            return
        if self._pending is not None:       # sweep-end batch (see sweep)
            self._pending.extend(all_ins)
            return
        # reference order at one gap: reverse discovery within a row
        all_ins.sort(key=lambda t: (t[0], t[1], -t[2]))
        self._do_inserts([(g, k, b) for g, k, o, b in all_ins])

    def _do_inserts(self, ins) -> None:
        """Splice inserted columns (each its own column, reference
        semantics; fills use the post-placement neighbor rule, which
        for chained same-gap inserts equals the reference's chained
        rule). ins: [(gap, row, base)] already in splice order; fills
        are computed against the pre-splice MSA for the whole batch."""
        if not ins:
            return
        msa, counts = self.msa, self.counts
        c = msa.shape[1]
        r_all = msa.shape[0]
        positions = []
        cols = []
        for gap, k, base in ins:
            col = np.full(r_all, 4, np.int8)
            if gap == c - 1:
                col[:] = 5
            else:
                nxt = msa[:, gap + 1]
                prv = msa[:, gap]
                col[(nxt == 5) | (prv == 5)] = 5
            col[k] = base
            positions.append(gap + 1)
            cols.append(col)
        cols_arr = np.stack(cols)                 # [n_ins, R]
        self.msa = _splice_cols(msa, positions, cols_arr)
        col_counts = np.stack(
            [np.bincount(col, minlength=6) for col in cols_arr]
        ).astype(counts.dtype)
        self.counts = _splice_rows(counts, positions, col_counts)


def realign_batched(msa: np.ndarray, cfg: RealignerConfig,
                    out_path=None, score_log: list | None = None,
                    block_rows: int | None = None,
                    checkpoint_path: str | None = None,
                    resume: bool = False,
                    stats: dict | None = None,
                    validate: bool = False,
                    mode: str = "auto",
                    kernel: str = "auto",
                    score_log_path: str | None = None,
                    mesh=None,
                    anneal: bool = True) -> np.ndarray:
    """Main loop with the device engine; same convergence contract as
    realign(). With checkpoint_path, state is saved atomically per
    improving round (the reference's best-MSA-per-round semantics,
    PW_ReAligner.c:1741) and resume=True restarts from it.

    mesh: a jax.sharding.Mesh with a 'rows' axis — each block's rows
    are sharded over it with the count-delta merged by psum
    (parallel/sharded.sharded_block_realign); trajectory is bit-equal
    to the single-device path.

    anneal: block-Jacobi sweeps (block_rows>1) can stall in a worse
    local optimum than the reference's strictly serial Gauss-Seidel —
    rows of one block don't see each other's updates, so near
    convergence their rewrites oscillate. With anneal=True the first
    non-improving round at block B restores the best MSA and continues
    at B//4, terminating only when a block-1 (exact reference
    semantics, PW_ReAligner.c:1741-1742) round fails to improve. The
    bulk of rounds run at full batch width; the tail polish recovers
    the serial-quality score. block_rows=1 is unaffected."""
    import time

    from ..utils import checkpoint as ckpt
    from ..utils import io as rio

    start_round = 0
    best = (1 << 62, 0)
    ck_bs = 0
    ck_widen_state = None
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        c = ckpt.RealignCheckpoint.load(checkpoint_path)
        msa = c.msa
        start_round = c.round
        best = (c.best_mille, c.best_uno)
        ck_bs = c.block_rows              # the anneal position
        if c.widen is not None:           # the learned drift ladder
            ck_widen_state = (c.widen_bs, c.widen,
                              tuple(int(b) for b in c.exact_blocks))

    auto = kernel == "auto" or mode == "auto"
    if auto:
        from .. import platform
        auto_kernel = kernel == "auto"
        mode, kernel = platform.realign_route(platform.name(), mode,
                                              kernel)
        if auto_kernel and kernel == "cuda" and \
                not BatchedRealigner.cuda_fits(cfg.bandwidth):
            kernel = "xla"     # a band too wide for the CUDA kernel
    bs = ck_bs or block_rows or cfg.block_rows
    if auto and ck_bs and ck_bs < 32:
        # a run resumed inside the anneal's tail (small blocks; 1 =
        # the reference's strictly serial Gauss-Seidel): host native
        # engine on every backend — the same handoff the resident
        # engine's shrink() makes (realigner_device.RESIDENT_MIN_BS)
        mode, kernel = "exact", "native"
    elif bs == 1 and auto:
        mode, kernel = "exact", "native"
    resident = (kernel in ("xla", "cuda") and mode == "staircase"
                and mesh is None and bs > 1
                and os.environ.get("RR_RESIDENT", "1") != "0")
    if resident:
        from .realigner_device import DeviceResidentRealigner
        eng = DeviceResidentRealigner(msa, bandwidth=cfg.bandwidth,
                                      block_rows=bs, kernel=kernel,
                                      widen_state=ck_widen_state)
    else:
        eng = BatchedRealigner(msa, bandwidth=cfg.bandwidth,
                               block_rows=bs, mode=mode,
                               kernel=kernel, mesh=mesh)
    first_eng = eng
    eng.ent_al_gapper()
    best_msa = None
    rounds = start_round
    t0 = time.perf_counter()
    cells = 0

    import threading
    writer: list = [None]         # in-flight best-MSA write thread
    write_stale = [False]         # best_msa newer than the last write

    def _eng_state():
        """Engine state snapshot for the checkpoint: the current block
        size (anneal position) + the device engine's learned drift
        ladder, captured on the caller's thread."""
        ws = getattr(eng, "widen_state", lambda: None)()
        return (int(eng.block_rows), ws)

    def _write_best(snapshot, pair, rnd, state=(0, None)):
        snapshot = np.asarray(snapshot)   # lazy device snapshots
        if out_path is not None:
            rio.write_msa(out_path, snapshot, upper=True)
        if checkpoint_path is not None:
            e_bs, ws = state
            ckpt.RealignCheckpoint(
                msa=snapshot, round=rnd, best_mille=pair[0],
                best_uno=pair[1], bandwidth=cfg.bandwidth,
                block_rows=e_bs,
                widen_bs=ws[0] if ws else 0,
                widen=ws[1] if ws else None,
                exact_blocks=np.asarray(ws[2], np.int64) if ws
                else None).save(checkpoint_path)

    def check_improved(write=True):
        nonlocal best, best_msa
        pair = eng.overall_pair()
        if score_log is not None:
            score_log.append(pair)
        if score_log_path is not None:
            # OverallScorePrintF format: round score width
            # (PW_ReAligner.c:965-1007)
            with open(score_log_path, "a") as f:
                f.write(f"{rounds} {pair[0]}{pair[1]:06d} "
                        f"{eng.width()}\n")
        if pair < best:
            best = pair
            best_msa = eng.best_snapshot()
            write_stale[0] = True
            if write and (out_path is not None
                          or checkpoint_path is not None):
                # overlap the multi-GB best-MSA write with the next
                # sweep (numpy encode + file I/O both release the GIL);
                # rounds run minutes, writes seconds, so at most one is
                # ever in flight
                if writer[0] is not None:
                    writer[0].join()
                write_stale[0] = False
                writer[0] = threading.Thread(
                    target=_write_best,
                    args=(best_msa, best, rounds, _eng_state()),
                    daemon=True)
                writer[0].start()
            return True
        return False

    check_improved(write=False)
    if checkpoint_path is not None and start_round == 0:
        # round-0 checkpoint right after EntAlGapper: a restarted run
        # resumes past the expensive MSA read + gapper setup even if
        # no sweep ever completed
        ckpt.RealignCheckpoint(
            msa=eng.msa, round=0, best_mille=best[0], best_uno=best[1],
            bandwidth=cfg.bandwidth).save(checkpoint_path)
    sweeps: dict = {}   # engine, route and block -> [rounds, seconds]
    while rounds < cfg.max_rounds:
        cells += eng.total_bases() * cfg.bandwidth
        t_sweep = time.perf_counter()
        eng.sweep()
        key = (f"{type(eng).__name__} {eng.mode}/{eng.kernel} "
               f"block {eng.block_rows}")
        rec = sweeps.setdefault(key, [0, 0.0])
        rec[0] += 1
        rec[1] += time.perf_counter() - t_sweep
        rounds += 1
        if validate:
            eng.validate()
        if not check_improved():
            if anneal and eng.block_rows > 1:
                nb = max(1, eng.block_rows // 4)
                if best_msa is not None and eng.overall_pair() > best:
                    # the stalled Jacobi round left the MSA worse than
                    # the checkpointed best — polish from the best
                    eng = eng.respawn(np.asarray(best_msa).copy(), nb)
                else:
                    eng = eng.shrink(nb)
                continue
            break
    eng.ent_al_gapper()
    check_improved()
    if writer[0] is not None:     # files must be complete on return
        writer[0].join()
    if write_stale[0] and best_msa is not None \
            and (out_path is not None or checkpoint_path is not None):
        # the round-0 best (never written by the reference's rule) is
        # the result when no round improved
        _write_best(best_msa, best, rounds, _eng_state())
    if stats is not None:
        dt = time.perf_counter() - t0
        stats.update(rounds=rounds, wall_s=dt, dp_cells=cells,
                     cells_per_s=cells / dt if dt > 0 else 0.0,
                     route=f"{type(first_eng).__name__} {mode}/{kernel}",
                     sweeps=sweeps)
    return (np.asarray(best_msa) if best_msa is not None
            else eng.msa)


def realign(msa: np.ndarray, cfg: RealignerConfig,
            out_path=None, score_log: list | None = None) -> np.ndarray:
    """The reference main loop (PW_ReAligner.c:1610-1759), serial mode.

    Returns the best MSA (also written to out_path per improving round
    when given, reproducing the reference's checkpoint-every-improving-
    round semantics)."""
    from ..utils import io as rio

    eng = RealignEngine(msa, bandwidth=cfg.bandwidth)
    eng.ent_al_gapper()
    best = (1 << 62, 0)
    best_msa = None

    def check_improved(write=True):
        nonlocal best, best_msa
        pair = eng.overall_pair()
        if score_log is not None:
            score_log.append(pair)
        if pair < best:
            best = pair
            best_msa = eng.msa.copy()
            if write and out_path is not None:
                rio.write_msa(out_path, best_msa, upper=True)
            return True
        return False

    # The reference prints (and records best) before round 1 but only
    # writes the output after an improving ROUND (main :1741).
    check_improved(write=False)
    rounds = 0
    while rounds < cfg.max_rounds:
        for k in range(eng.msa.shape[0]):
            eng.realign_row(k)
        rounds += 1
        if not check_improved():
            break
    eng.ent_al_gapper()
    if check_improved():
        pass
    return best_msa if best_msa is not None else eng.msa
