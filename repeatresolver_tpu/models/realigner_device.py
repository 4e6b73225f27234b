"""Device-resident realignment engine: the MSA lives in device memory.

The host-orchestrated BatchedRealigner uploads every block's rows,
counts and per-row streams and downloads every block's rewritten rows,
a host round trip per block. This engine keeps the whole MSA and its
column histogram resident on the device and runs a sweep as a stream
of asynchronous dispatches with ONE host synchronization per sweep:

  * msa_d int8 [R, CPAD] and counts_d int32 [CPAD, 6] live on device
    in LOGICAL column order with a static capacity CPAD (width changes
    from splices/compaction move inside the capacity; `ncols` is a
    traced scalar), so the whole run compiles one block_step per
    row-length bucket — no width-driven recompiles;
  * block_step (donated buffers, one dispatch per block): gathers the
    block's rows, compacts them into (seqs, ways) streams on device
    (cumsum + drop-mode scatter), runs the staircase fill named by the
    engine's `kernel` and the walk (ops/staircase_realign.py), and
    applies the rewritten rows and the count delta in place — the
    reference's Columns_Downdater / Column_Updater
    (PW_ReAligner.c:1172-1243) as one fused device op;
  * insert lists, per-block best scores, and drift scalars are fetched
    asynchronously and consumed at sweep end, where the host builds
    the splice-and-compaction plan (reference Column_Adder / W_Con
    semantics, PW_ReAligner.c:1245-1332, 706-763) and applies it as
    ONE device regather;
  * the staircase drift slack (`widen`) is fixed per dispatch instead
    of measured per block (a per-block measurement would force a host
    sync before every dispatch); every block's actual drift is
    validated at sweep end, and a violation restores the sweep-start
    device snapshot, raises the slack one rung, and redoes the sweep —
    the same "window must cover the band" contract the host path
    enforces per block.

Trajectory parity: given the same block order and flush points, every
sweep's math is the host path's math (same fill and walk, same splice
plan, same drop points), so the (mille, uno) score trajectory and the
final MSA are bit-equal to BatchedRealigner(mode="staircase") —
asserted by tests/test_realigner_device.py on the CPU. The one
permitted difference is the fixed `widen`: the staircase window is
drift slack, not extra band, so any slack covering the drift yields
identical DP results (also asserted).
"""
from __future__ import annotations

import functools
import os

import numpy as np

from .realigner import BatchedRealigner, overall_score_pair

MAX_INSERTS_FETCH = 512   # insert slots fetched per block (per sweep
                          # a row inserts ~0-5 columns; a row
                          # overflowing the window is handled like a
                          # drift violation: the sweep restores its
                          # start snapshot and redoes with that block
                          # routed through the exact host fallback,
                          # whose insert buffer grows on demand —
                          # override via RR_INS_FETCH)


def length_bucket(n: int) -> int:
    """Row-length bucket of a block step: powers of two from 256 with a
    3/4 rung between, so a run compiles a few lengths only."""
    v = 256
    while v < n:
        v *= 2
    return int(v * 0.75) if v > 256 and v * 0.75 >= n else v


@functools.lru_cache(maxsize=None)
def _jits(bandwidth: int, chunk: int, widen: int, lpad: int, bq: int,
          maxf: int, kernel: str):
    """The compiled block step for one (band, chunk, widen, lpad,
    block, fill) combo. The step reads its block's rows and lengths
    from device-resident order arrays (a traced offset — no per-block
    upload) and returns ONE packed int32 fetch buffer
    [bq*maxf insert codes | bq insert counts | drift], so the per-block
    host traffic is one dispatch and one small download."""
    import jax
    import jax.numpy as jnp

    from ..ops import staircase_realign as sr

    bh = bandwidth // 2
    w2 = bandwidth + widen * chunk
    fill = sr.fill_for(kernel)

    def block_step(msa_d, counts_d, order_d, len_d, k0, ncols):
        rows = jax.lax.dynamic_slice_in_dim(order_d, k0, bq)
        lengths = jax.lax.dynamic_slice_in_dim(len_d, k0, bq)
        b = bq
        cpad = msa_d.shape[1]
        rows_ok = rows >= 0
        rows_cl = jnp.maximum(rows, 0)
        rows_old = jnp.take(msa_d, rows_cl, axis=0)
        rows_old = jnp.where(rows_ok[:, None], rows_old, jnp.int8(5))

        # compact each row's bases into (seqs, ways) streams: one
        # cumsum + one packed drop-mode scatter
        isb = rows_old < 4
        pos = jnp.cumsum(isb.astype(jnp.int32), axis=1) - 1
        cols = jnp.arange(cpad, dtype=jnp.int32)[None, :]
        tgt = jnp.where(isb & (pos < lpad), pos, lpad)
        packed = (cols << 2) | rows_old.astype(jnp.int32)
        buf = jnp.zeros((b, lpad), jnp.int32)
        buf = buf.at[jnp.arange(b)[:, None], tgt].set(packed,
                                                      mode="drop")
        ways = buf >> 2
        seqs = (buf & 3).astype(jnp.int8)
        xs = jnp.arange(lpad, dtype=jnp.int32)[None, :]
        inlen = xs < lengths[:, None]
        last_way = jnp.take_along_axis(
            ways, jnp.maximum(lengths[:, None] - 1, 0), axis=1)
        ways = jnp.where(inlen, ways, last_way)
        seqs = jnp.where(inlen, seqs, 0)

        # staircase window starts (staircase_anf semantics: constant
        # per chunk from the chunk's first position; lpad need not be a
        # chunk multiple) + per-block drift, validated at sweep end
        # against widen*chunk with the host path's exact formula
        nc = -(-lpad // chunk)
        starts_i = jnp.arange(nc, dtype=jnp.int32) * chunk
        ends_i = jnp.minimum(starts_i + chunk - 1, lpad - 1)
        w_start = jnp.take(ways, starts_i, axis=1)        # [bs, NC]
        w_end = jnp.take(ways, ends_i, axis=1)
        drift = jnp.max(w_end - w_start)
        a_chunks = jnp.maximum(0, w_start - bh)
        anf_full = jnp.repeat(a_chunks, chunk, axis=1)[:, :lpad]
        entry_bound = jnp.maximum(-1, last_way[:, 0] - bh)

        codes, fband, fanf = fill(
            counts_d, rows_old, seqs, ways, lengths, ncols,
            bandwidth=bandwidth, chunk=chunk, widen=widen)
        new_rows, best, iy, ib, inn = sr.entry_and_walk(
            codes, fband, fanf, seqs, anf_full, entry_bound, lengths,
            ncols, cpad=cpad, bandwidth=w2, chunk=chunk)

        # in-place apply: row scatter + histogram delta (the column
        # count update), padding rows dropped
        sym = jnp.arange(6, dtype=jnp.int32)[None, None, :]
        okm = rows_ok[:, None, None]

        def hist(r):
            eq = (r.astype(jnp.int32)[:, :, None] == sym) & okm
            return eq.sum(axis=0, dtype=jnp.int32)

        delta = hist(new_rows) - hist(rows_old)
        msa_d = msa_d.at[
            jnp.where(rows_ok, rows, msa_d.shape[0])].set(
            new_rows, mode="drop")
        counts_d = counts_d + delta
        iyb = (iy[:, :maxf] << 2) | ib[:, :maxf].astype(jnp.int32)
        out = jnp.concatenate(
            [iyb.reshape(-1), inn.astype(jnp.int32),
             drift.reshape(1)])
        return msa_d, counts_d, out

    return jax.jit(block_step, donate_argnums=(0, 1))


@functools.lru_cache(maxsize=None)
def _apply_jit():
    """Donated in-place apply of externally-computed rewritten rows
    (the exact-fallback path): row scatter + histogram delta."""
    import jax
    import jax.numpy as jnp

    def apply(msa_d, counts_d, rows, new_rows):
        rows_ok = rows >= 0
        rows_old = jnp.take(msa_d, jnp.maximum(rows, 0), axis=0)
        rows_old = jnp.where(rows_ok[:, None], rows_old, jnp.int8(5))
        new_rows = jnp.where(rows_ok[:, None], new_rows, jnp.int8(5))
        sym = jnp.arange(6, dtype=jnp.int32)[None, None, :]

        def hist(r):
            eq = r.astype(jnp.int32)[:, :, None] == sym
            return eq.sum(axis=0, dtype=jnp.int32)

        delta = hist(new_rows) - hist(rows_old)
        msa_d = msa_d.at[jnp.where(rows_ok, rows,
                                   msa_d.shape[0])].set(
            new_rows, mode="drop")
        return msa_d, counts_d + delta

    return jax.jit(apply, donate_argnums=(0, 1))


@functools.lru_cache(maxsize=None)
def _regather_jit(npad: int):
    """One device op for the sweep-end splice + empty-column drop:
    gather the surviving/new column order, build the inserted columns
    (reference Column_Adder neighbor rule against the pre-splice MSA),
    and write them in. npad: padded insert count (oob-sentinel lanes
    are dropped)."""
    import jax
    import jax.numpy as jnp

    def regather(msa_d, counts_d, gmap, ins_gap, ins_newpos, ins_row,
                 ins_base, ncols):
        r, cpad = msa_d.shape
        gm = jnp.clip(gmap, 0, cpad - 1)
        msa2 = jnp.take(msa_d, gm, axis=1)
        counts2 = jnp.take(counts_d, gm, axis=0)
        # inserted columns from PRE-splice neighbors (realigner
        # _do_inserts contract): 5 where either neighbor is 5 (or the
        # gap is the last column), else 4; owner cell gets its base
        gap_cl = jnp.clip(ins_gap, 0, cpad - 1)
        prv = jnp.take(msa_d, gap_cl, axis=1)            # [R, NPAD]
        nxt = jnp.take(msa_d, jnp.clip(ins_gap + 1, 0, cpad - 1),
                       axis=1)
        col = jnp.where((prv == 5) | (nxt == 5)
                        | (ins_gap == ncols - 1)[None, :],
                        jnp.int8(5), jnp.int8(4))
        col = col.at[jnp.clip(ins_row, 0, r - 1),
                     jnp.arange(npad)].set(
            jnp.where(ins_row >= 0, ins_base, col[
                jnp.clip(ins_row, 0, r - 1), jnp.arange(npad)]))
        msa2 = msa2.at[:, jnp.where(ins_row >= 0, ins_newpos,
                                    cpad)].set(col, mode="drop")
        sym = jnp.arange(6, dtype=jnp.int32)[None, None, :]
        ch = (col.astype(jnp.int32)[:, :, None] == sym).sum(
            axis=0, dtype=jnp.int32)                      # [NPAD, 6]
        counts2 = counts2.at[jnp.where(ins_row >= 0, ins_newpos,
                                       cpad)].set(ch, mode="drop")
        return msa2, counts2

    return jax.jit(regather, donate_argnums=(0, 1))


@functools.lru_cache(maxsize=None)
def _pad_jit(cpad: int):
    """Upload helper: pad the MSA's columns to the device capacity with
    blanks (5) on the device, so no padded host copy is made."""
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda m: jnp.pad(
        m, ((0, 0), (0, cpad - m.shape[1])), constant_values=5))


class DeviceResidentRealigner(BatchedRealigner):
    """BatchedRealigner with the MSA resident on the device.

    Staircase mode only, with `kernel` naming the fill ("xla" or
    "cuda", ops/staircase_realign.fill_for), no mesh, block_rows > 1;
    anything else uses the base class.
    """

    def __init__(self, msa: np.ndarray, bandwidth: int = 1000,
                 block_rows: int = 64, mode: str = "staircase",
                 chunk: int = 256, kernel: str = "xla", mesh=None,
                 widen_state=None):
        if mode != "staircase" or kernel not in ("xla", "cuda"):
            raise ValueError(f"resident engine runs the staircase fills "
                             f"only, not {mode}/{kernel}")
        if mesh is not None or block_rows < 2:
            raise ValueError("resident engine: no mesh, block_rows > 1")
        super().__init__(msa, bandwidth=bandwidth,
                         block_rows=block_rows, mode=mode, chunk=chunk,
                         kernel=kernel)
        self._widen = int(os.environ.get("RR_RESIDENT_WIDEN", "12"))
        self._maxf = int(os.environ.get("RR_INS_FETCH",
                                        str(MAX_INSERTS_FETCH)))
        self._overflow_events = 0         # insert-fetch overflows seen
        self._block_widen = None          # per-block adaptive slack
        self._widen_src_bs = None         # block size _block_widen is
        #                                   laid out for (survives
        #                                   checkpoints and respawns)
        self._widen_state = widen_state   # (src_bs, widen[], exact[])
        #                                   from a checkpoint/respawn,
        #                                   adopted lazily
        self._ord_bs = None               # block layout bookkeeping
        self._order_d = self._len_d = None
        self._msa_d = None                # device [R, CPAD] int8
        self._counts_d = None             # device [CPAD, 6] int32
        self._ncols = None
        self._cpad = None
        self._lengths_all = None
        self._exact_blocks: set = set()   # block ids on the exact path

    # ------------------------------------------------ device lifecycle

    def _upload(self):
        import jax
        r, c = self.msa.shape
        # early sweeps insert tens of thousands of columns before the
        # sweep-end drops reclaim them (paper round 1: width 134k ->
        # 153k net, higher transiently) — size the capacity for that,
        # with on-demand growth (_flush_device) as the backstop
        slack = max(32768, c // 3)
        cpad = -(-(c + slack) // 1024) * 1024
        self._msa_d = _pad_jit(cpad)(jax.device_put(self.msa))
        cnt_p = np.zeros((cpad, 6), np.int32)
        cnt_p[:c] = self.counts
        self._counts_d = jax.device_put(cnt_p)
        self._ncols = c
        self._cpad = cpad
        self._lengths_all = (self.msa < 4).sum(axis=1).astype(np.int32)
        if getattr(self, "_len_order", None) is None:
            self._len_order = np.argsort(-self._lengths_all,
                                         kind="stable")
        self._order_d = self._len_d = None  # rebuilt lazily

    def _ensure_order_device(self):
        """Device-resident block layout: each block's row ids and
        lengths at stride bq = bs, the last block's padding lanes
        -1/0 — so a block step needs only a traced
        offset, not a per-block index upload. Also owns the per-block
        adaptive-slack array: on a block-size change (the anneal
        mutates block_rows) each new block inherits the max slack of
        the old blocks its rows came from, and exact-path flags
        propagate to every new block containing a flagged row."""
        import jax
        bs = self.block_rows
        if self._ord_bs == bs and self._order_d is not None:
            return
        bq = bs
        r = self.msa.shape[0]
        nb = -(-r // bs)
        if self._block_widen is None:
            if self._widen_state is not None:
                # adopt a learned drift ladder from a checkpoint or a
                # respawn (restart-proofing: a resumed run dispatches
                # at the learned slack, not the configured worst case)
                src_bs, w, ex = self._widen_state
                self._widen_state = None
                self._block_widen = np.asarray(w, np.int32).copy()
                self._widen_src_bs = int(src_bs)
                self._exact_blocks = {int(b) for b in ex}
            else:
                # sweep 0 runs everything at the configured slack;
                # every later block runs one ladder rung above its last
                # measured drift (_drain adapts) — at paper scale drift
                # sits near 4.6x chunk, so the adaptive window is
                # ~2.5 kB-wide instead of the 4 kB worst case: ~1.6x
                # less fill work per sweep for the same (slack-neutral)
                # result
                self._block_widen = np.full(nb, self._widen, np.int32)
                self._widen_src_bs = bs
        if self._widen_src_bs != bs or len(self._block_widen) != nb:
            # re-lay the per-block ladder for a new block size (the
            # anneal mutates block_rows): each new block inherits the
            # max slack of the old blocks its rows came from, and
            # exact-path flags propagate to every new block containing
            # a flagged row
            old_bs = self._widen_src_bs
            per_row = np.repeat(self._block_widen, old_bs)[:r]
            if len(per_row) < r:          # defensive: pad short maps
                per_row = np.concatenate(
                    [per_row,
                     np.full(r - len(per_row), self._widen, np.int32)])
            ex_row = np.zeros(r, bool)
            for b in self._exact_blocks:
                ex_row[b * old_bs:(b + 1) * old_bs] = True
            neww = np.full(nb, self._widen, np.int32)
            newex = set()
            for bid in range(nb):
                sl = slice(bid * bs, min((bid + 1) * bs, r))
                neww[bid] = per_row[sl].max()
                if ex_row[sl].any():
                    newex.add(bid)
            self._block_widen = neww
            self._exact_blocks = newex
            self._widen_src_bs = bs
        ordp = np.full(nb * bq, -1, np.int32)
        lenp = np.zeros(nb * bq, np.int32)
        for bid in range(nb):
            blk = self._len_order[bid * bs:bid * bs + bs].astype(
                np.int32)
            ordp[bid * bq:bid * bq + len(blk)] = blk
            lenp[bid * bq:bid * bq + len(blk)] = \
                self._lengths_all[blk]
        self._order_d = jax.device_put(ordp)
        self._len_d = jax.device_put(lenp)
        self._ord_host = ordp
        self._len_host = lenp
        self._ord_bs = bs
        self._ord_bq = bq

    def _fetch_msa_host(self) -> np.ndarray:
        """The resident MSA as a fresh writable host array [R, ncols]."""
        return np.ascontiguousarray(np.asarray(self._msa_d)[:, :self._ncols])

    def _fetch_counts_host(self) -> np.ndarray:
        """The resident column histogram [ncols, 6] as int64."""
        return np.asarray(self._counts_d)[:self._ncols].astype(np.int64)

    def _sync_host(self):
        """Materialize the device state back into the host mirrors."""
        if self._msa_d is None:
            return
        self.msa = self._fetch_msa_host()
        self.counts = self._fetch_counts_host()
        self._msa_d = self._counts_d = None

    def ent_al_gapper(self):
        self._sync_host()
        super().ent_al_gapper()

    def overall_pair(self):
        if self._msa_d is None:
            return super().overall_pair()
        return overall_score_pair(self.counts)

    def width(self) -> int:
        return self._ncols if self._msa_d is not None \
            else self.msa.shape[1]

    def total_bases(self) -> int:
        return int(self.counts[:, 0:4].sum())

    def best_snapshot(self):
        """A copy of the current MSA for best-tracking: a device-side
        copy when resident (downloaded when np.asarray reads it, on the
        best-MSA writer thread), a host copy otherwise."""
        if self._msa_d is None:
            return self.msa.copy()
        return _LazySnapshot(self._msa_d.copy(), self._ncols)

    def validate(self):
        from .realigner import validate_counts
        if self._msa_d is None:
            validate_counts(self.msa, self.counts)
            return
        validate_counts(self._fetch_msa_host(),
                        self._fetch_counts_host())

    def widen_state(self):
        """The learned drift ladder as a checkpointable tuple
        (src_block_rows, widen[], exact_block_ids[]) — None before the
        first sweep ever laid it out."""
        if self._block_widen is None:
            return self._widen_state
        return (int(self._widen_src_bs), self._block_widen.copy(),
                tuple(sorted(self._exact_blocks)))

    # below this block size the anneal hands the run to the host
    # native engine: a resident sweep pays per-block dispatch latency
    # (fetch round trips, donation bookkeeping) that is amortized at
    # production block sizes but dominates at small ones. The value is
    # not yet measured on the GPU. Block-k exact band and block-k
    # staircase (with covering slack) are the same math over the same
    # length-sorted Jacobi blocks, so the trajectory contract is
    # unchanged (kernel-independence asserted by
    # tests/test_batched_realigner.py).
    RESIDENT_MIN_BS = int(os.environ.get("RR_RESIDENT_MIN_BS", "32"))

    def _host_engine(self, msa, block_rows):
        return BatchedRealigner(msa, bandwidth=self.bandwidth,
                                block_rows=block_rows, mode="exact",
                                kernel="native")

    def respawn(self, msa, block_rows):
        if block_rows >= self.RESIDENT_MIN_BS:
            return DeviceResidentRealigner(
                msa, bandwidth=self.bandwidth, block_rows=block_rows,
                mode=self.mode, chunk=self.chunk, kernel=self.kernel,
                widen_state=self.widen_state())
        # the anneal's tail (small blocks, block 1 = the reference's
        # strictly serial Gauss-Seidel) runs on the host native engine
        return self._host_engine(msa, block_rows)

    def shrink(self, block_rows):
        if block_rows >= self.RESIDENT_MIN_BS:
            self.block_rows = block_rows
            return self
        self._sync_host()
        return self._host_engine(self.msa, block_rows)

    # ------------------------------------------------------- the sweep

    def sweep(self) -> None:
        if self.block_rows == 1:
            # serial mode is host territory: block-1 staircase on
            # device would pay one dispatch per ROW; the native exact
            # engine runs the identical reference walk (see respawn)
            self._sync_host()
            self.kernel = "native"
            self.mode = "exact"
            super().sweep()
            return
        if self._msa_d is None:
            self._upload()
        extra_exact: set = set()   # this sweep only: overflow redos
        for _ in range(8):
            snap_m = self._msa_d + 0      # sweep-start snapshot for
            snap_c = self._counts_d + 0   # the drift-violation redo
            snap_n = self._ncols
            violations = self._try_sweep(extra_exact)
            if not violations:
                return
            # some blocks violated their dispatch contract: restore the
            # sweep-start state and redo. Drift violations whose drift
            # any ladder rung covers were already bumped by _drain's
            # adaptation and retry on the (wider) staircase; the rest
            # (short fragments spread over wide spans drift
            # arbitrarily) route through the exact host fallback
            # permanently — the same ladder-overflow split the host
            # engine makes (realigner._realign_block). Insert-fetch
            # overflows (sentinel -1) route through the exact fallback
            # for THIS sweep only (its insert buffer grows on demand);
            # insert pressure is transient, so the block returns to the
            # fast path next sweep.
            self._msa_d, self._counts_d = snap_m, snap_c
            self._ncols = snap_n
            lad_max = BatchedRealigner.WIDEN_LADDER[-1] * self.chunk
            self._exact_blocks |= {
                bid for bid, dv in violations.items() if dv > lad_max}
            extra_exact |= {
                bid for bid, dv in violations.items() if dv < 0}
        raise RuntimeError("drift fallback did not converge")

    def _try_sweep(self, extra_exact=()) -> dict:
        """One sweep; returns a (possibly empty) {block id: drift}
        map for blocks whose drift violated their staircase slack or
        whose insert list overflowed the fetch window (drift -1); the
        caller restores and redoes — wider, or on the exact path.
        extra_exact: block ids routed through the exact fallback for
        this sweep only (overflow redos)."""
        r = self.msa.shape[0]
        bs = self.block_rows
        pending: list = []
        fetches: list = []
        violations: dict = {}
        cap = self._flush_cap
        log_every = int(os.environ.get("RR_SWEEP_LOG", "0") or 0)
        import time as _time
        t_start = _time.perf_counter()

        self._ensure_order_device()
        bq = self._ord_bq
        nb = -(-r // bs)
        for bid in range(nb):
            if log_every and bid % log_every == 0:
                print(f"[resident] block {bid}/{nb} "
                      f"elapsed {_time.perf_counter() - t_start:.0f}s "
                      f"pending {len(pending)} widen "
                      f"{int(self._block_widen.min())}-"
                      f"{int(self._block_widen.max())}",
                      flush=True)
            rows = self._ord_host[bid * bq:(bid + 1) * bq]
            bl = self._len_host[bid * bq:(bid + 1) * bq]
            if bid in self._exact_blocks or bid in extra_exact:
                self._exact_block(rows, bl, pending)
            else:
                lpad = length_bucket(max(1, int(bl.max())))
                wd = int(self._block_widen[bid])
                step = _jits(self.bandwidth, self.chunk, wd,
                             lpad, bq, self._maxf, self.kernel)
                (self._msa_d, self._counts_d, out) = step(
                    self._msa_d, self._counts_d, self._order_d,
                    self._len_d, np.int32(bid * bq),
                    np.int32(self._ncols))
                fetches.append((bid, rows, out, wd))

            # drain fetches a few blocks behind the dispatch horizon:
            # the pipeline never stalls (those results are long done),
            # and the cap check below sees a pending count at most 3
            # blocks stale — so a cap-triggered mid-sweep flush can
            # land up to 3 blocks later than the host path's (both
            # valid flush points of the same Jacobi sweep; paper-scale
            # sweeps stay under the cap entirely)
            while len(fetches) > 3:
                self._drain(fetches.pop(0), pending, violations)
            # on a violation the sweep is already doomed (that block's
            # apply corrupted the counts): keep dispatching to LEARN
            # every violating block's drift in this one pass (their
            # work is discarded on the redo anyway), but stop splicing
            if not violations and len(pending) >= cap:
                while fetches:
                    self._drain(fetches.pop(0), pending, violations)
                if violations:
                    continue
                # mid-sweep flushes also drop empty columns here
                # (the host path splices only): it bounds the
                # transient width in insert-heavy early sweeps, at the
                # cost of deviating from the host trajectory whenever
                # a sweep crosses the cap — another valid geometry
                # point of the same Jacobi sweep
                self._flush_device(pending, drop_empty=True)
                pending = []

        while fetches:
            self._drain(fetches.pop(0), pending, violations)
        if violations:
            return violations
        self._flush_device(pending, drop_empty=True)
        return violations

    def _drain(self, item, pending, violations: dict) -> None:
        """Materialize one block's async outputs into the pending
        insert list; drift violations land in `violations`. Every
        drain also adapts the block's slack for its NEXT dispatch: one
        ladder rung above the rung covering the measured drift (drift
        moves slowly sweep-to-sweep; the margin rung absorbs it, and a
        rare miss costs one redo pass)."""
        bid, rows, out, wd = item
        out = np.asarray(out)
        bqn = len(rows)
        dv = int(out[-1])
        t = self.chunk
        lad = BatchedRealigner.WIDEN_LADDER
        i = next((j for j, v in enumerate(lad) if v * t >= dv), None)
        if i is not None:
            self._block_widen[bid] = lad[min(i + 1, len(lad) - 1)]
        if dv > wd * t:
            violations[bid] = dv
            return
        maxf = self._maxf
        inn = out[bqn * maxf:bqn * maxf + bqn]
        if (inn > 0).any():
            if (inn > maxf).any():
                # a row's insert list overflowed the fetch window: the
                # tail slots never left the device, so the block's
                # in-place apply lost bases. Treat it like a drift
                # violation (sentinel -1): the caller restores the
                # sweep-start snapshot and redoes with this block on
                # the exact host fallback, whose insert buffer grows
                # on demand (the documented full-list refetch).
                self._overflow_events += 1
                violations[bid] = -1
                return
            iyb = out[:bqn * maxf].reshape(bqn, maxf)
            for b, k in enumerate(rows):
                if k < 0:
                    continue
                for o in range(int(inn[b])):
                    v = int(iyb[b, o])
                    pending.append((v >> 2, int(k), o, v & 3))

    def _exact_block(self, rows, bl, pending) -> None:
        """Exact-band realignment for a block whose column-path drift
        exceeds any staircase slack, via the NATIVE HOST engine — the
        same code the host path's widen-ladder overflow falls back to
        (realigner._realign_block kernel="native" branch), so the math
        is parity-identical by construction. Fetch the block's rows
        (~10 MB) and counts (~4 MB), realign on host, push the
        rewritten rows back through the donated device apply. A sync
        point per such block — they are rare (short fragments spread
        over wide spans, a few blocks per early sweep), and the device
        alternative (an exact gather-based fill) materializes
        [B, L, W] codes — multi-GB at paper-scale row lengths."""
        import jax.numpy as jnp

        from ..utils import native as nat
        rows_cl = np.maximum(rows, 0)
        rows_old = np.asarray(jnp.take(self._msa_d,
                                       jnp.asarray(rows_cl), axis=0))
        rows_old = np.where((rows >= 0)[:, None], rows_old,
                            np.int8(5)).astype(np.int8)
        c = self._ncols
        counts = np.asarray(self._counts_d)[:c]
        rows_host = np.ascontiguousarray(rows_old[:, :c])
        bs = len(rows)
        lmax = max(1, int(bl.max()))
        lpad = -(-lmax // 256) * 256
        seqs = np.zeros((bs, lpad), np.int8)
        ways = np.zeros((bs, lpad), np.int32)
        for b in range(bs):
            if rows[b] < 0 or bl[b] == 0:
                continue
            pos = np.nonzero(rows_host[b] < 4)[0]
            seqs[b, :len(pos)] = rows_host[b][pos]
            ways[b, :len(pos)] = pos
            if len(pos) < lpad:
                ways[b, len(pos):] = pos[-1]
        cap = 512
        while True:
            res = nat.realign_block(counts, rows_host, seqs, ways,
                                    np.asarray(bl, np.int32),
                                    self.bandwidth, ins_cap=cap)
            if res is None or not (res[4] >= cap).any():
                break
            cap = max(cap * 2, int(res[4].max()) + 1)
        if res is not None:
            new_rows, _best, iy, ib, inn = res
        else:
            # the auto path must degrade, not abort (realigner.py's
            # own principle): without the native lib, run the same
            # exact-band math through the XLA banded fill + backtrack
            new_rows, iy, ib, inn = self._exact_block_xla(
                counts, rows_host, seqs, ways, bl)
        nr_p = np.full((bs, self._cpad), 5, np.int8)
        nr_p[:, :c] = new_rows
        apply_fn = _apply_jit()
        self._msa_d, self._counts_d = apply_fn(
            self._msa_d, self._counts_d, jnp.asarray(rows),
            jnp.asarray(nr_p))
        if (inn > 0).any():
            for b, k in enumerate(rows):
                if k < 0:
                    continue
                for o in range(int(inn[b])):
                    pending.append((int(iy[b, o]), int(k), o,
                                    int(ib[b, o])))

    def _exact_block_xla(self, counts, rows_host, seqs, ways, bl):
        """Exact-band realignment through the XLA banded fill +
        backtrack (ops/banded_realign) — the degrade path when the
        native host lib is unavailable. Sub-blocked so the unpacked
        [B, L, W] codes tensor stays inside the HBM budget. Same math
        as the native engine (both are the reference recurrence,
        PW_ReAligner.c:1493-1513); insert capacity is the device-wide
        MAX_INSERTS."""
        from ..ops import banded_realign as br
        bs, c = rows_host.shape
        bh = self.bandwidth // 2
        lpad = seqs.shape[1]
        sub = max(1, min(
            bs, int(self._hbm_budget // max(1,
                                           2 * lpad * self.bandwidth))))
        outs = []
        for s0 in range(0, bs, sub):
            sl = slice(s0, s0 + sub)
            lens = np.ascontiguousarray(bl[sl]).astype(np.int32)
            codes, fband, fanf = br.banded_fill(
                counts, rows_host[sl], seqs[sl], ways[sl], lens,
                np.int32(c), bandwidth=self.bandwidth)
            anf_full = np.maximum(0, ways[sl] - bh).astype(np.int32)
            last_way = ways[sl][np.arange(len(lens)),
                                np.maximum(lens - 1, 0)]
            entry_bound = np.maximum(-1, last_way - bh).astype(np.int32)
            new_rows, _best, iy, ib, inn = br.entry_and_backtrack(
                codes, fband, fanf, seqs[sl], anf_full, entry_bound,
                lens, np.int32(c), cpad=c, bandwidth=self.bandwidth)
            outs.append((np.asarray(new_rows)[:, :c], np.asarray(iy),
                         np.asarray(ib), np.asarray(inn)))
        new_rows = np.concatenate([o[0] for o in outs])
        iy = np.concatenate([o[1] for o in outs])
        ib = np.concatenate([o[2] for o in outs])
        inn = np.concatenate([o[3] for o in outs])
        if (inn >= br.MAX_INSERTS).any():
            raise RuntimeError("insert buffer overflow; raise "
                               "MAX_INSERTS or use the serial engine")
        return new_rows, iy, ib, inn

    def _flush_device(self, pending, drop_empty: bool) -> None:
        """Sweep-end (or cap-triggered) splice + optional empty-column
        compaction as one device regather; host mirrors updated."""
        import jax.numpy as jnp
        counts_now = np.asarray(self._counts_d)[:self._ncols]
        c = self._ncols
        if pending:
            pending.sort(key=lambda t: (t[0], t[1], -t[2]))
            positions = np.array([g + 1 for g, k, o, b in pending],
                                 np.int64)
            ins_gap = np.array([g for g, k, o, b in pending], np.int32)
            ins_row = np.array([k for g, k, o, b in pending], np.int32)
            ins_base = np.array([b for g, k, o, b in pending], np.int8)
        else:
            positions = np.zeros(0, np.int64)
            ins_gap = ins_row = np.zeros(0, np.int32)
            ins_base = np.zeros(0, np.int8)
        n = len(positions)
        keep = None
        if drop_empty:
            keep = counts_now[:, 0:4].sum(axis=1) > 0
            if keep.all() and n == 0:
                self.counts = counts_now.astype(np.int64)
                return
        elif n == 0:
            self.counts = counts_now.astype(np.int64)
            return

        # new logical order: np.insert semantics over the kept columns
        # (inserted columns are never empty, so splice-then-drop equals
        # drop-then-splice on this plan)
        keep_idx = (np.flatnonzero(keep) if keep is not None
                    else np.arange(c, dtype=np.int64))
        # np.insert positions index the PRE-drop axis; an insert's rank
        # among kept columns is the count of kept columns before it,
        # and the j-th insert (positions ascending, ties in pend
        # order — np.insert stacking order) lands at rank + j
        pos_kept = np.searchsorted(keep_idx, positions, side="left")
        c_new = len(keep_idx) + n
        if c_new > self._cpad:
            # grow the device capacity in place (one pad each; the
            # block step recompiles for the new width — rare)
            grow = -(-(c_new + max(16384, c_new // 8)) // 1024) * 1024
            self._msa_d = jnp.pad(
                self._msa_d, ((0, 0), (0, grow - self._cpad)),
                constant_values=np.int8(5))
            self._counts_d = jnp.pad(
                self._counts_d, ((0, grow - self._cpad), (0, 0)))
            self._cpad = grow
        newpos_of_ins = (pos_kept
                         + np.arange(n, dtype=np.int64)).astype(
            np.int32)
        # gmap[j] = source OLD column for new col j; inserted lanes
        # point at their gap (overwritten by the built columns)
        gmap = np.full(self._cpad, self._cpad - 1, np.int32)
        kept_mask = np.ones(c_new, bool)
        kept_mask[newpos_of_ins] = False
        gmap[:c_new][kept_mask] = keep_idx.astype(np.int32)
        gmap[:c_new][newpos_of_ins] = ins_gap

        npad = max(256, -(-n // 256) * 256)
        ig = np.full(npad, self._cpad - 1, np.int32)
        ig[:n] = ins_gap
        inp = np.full(npad, self._cpad, np.int32)
        inp[:n] = newpos_of_ins
        irow = np.full(npad, -1, np.int32)
        irow[:n] = ins_row
        ibase = np.zeros(npad, np.int8)
        ibase[:n] = ins_base

        reg = _regather_jit(npad)
        self._msa_d, self._counts_d = reg(
            self._msa_d, self._counts_d, jnp.asarray(gmap),
            jnp.asarray(ig), jnp.asarray(inp), jnp.asarray(irow),
            jnp.asarray(ibase), np.int32(c))
        self._ncols = c_new
        self.counts = self._fetch_counts_host()


class _LazySnapshot:
    """A device-side MSA copy that is downloaded on np.asarray — lets
    the best-MSA writer thread pay the download off the sweep path."""

    def __init__(self, msa_d, ncols):
        self._dev = msa_d                # a fresh copy: never donated
        self._ncols = ncols
        self.shape = (msa_d.shape[0], ncols)
        self._np = None

    def __array__(self, dtype=None, copy=None):
        if self._np is None:
            self._np = np.ascontiguousarray(
                np.asarray(self._dev)[:, :self._ncols])
            self._dev = None
        a = self._np
        return a.astype(dtype) if dtype is not None else a

    def copy(self):
        return np.asarray(self).copy()
