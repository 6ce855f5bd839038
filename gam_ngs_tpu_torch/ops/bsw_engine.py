"""Batched banded Smith-Waterman engine on one or several torch devices.

The counterpart of gam_ngs_tpu/ops/bsw_batch.py::BswEngine: problems are
clipped by `_prepare`, bucketed by the window buckets (`_pad_dim`),
chunked by max_batch and the device-memory budget, and uploaded as
4-bit packed windows.  Each chunk runs a forward kernel: the
anti-diagonal one (ops.bsw_antidiag) or, with kernel="row"
(GAM_KERNEL=row) or the host traceback, the row-form one (ops.bsw_row).

Device traceback: the find-max + walk kernel (ops.bsw_walk) follows the
forward on the device.  Every chunk is dispatched before any result is
fetched; each chunk's fetch is one (14, B) int32 summary (`lean`), or
that plus the edit codes (`edits`).  The direction words stay on the
device and are freed once the walk is queued.  On CUDA each chunk's
upload, kernels and fetch run on one stream of a fixed pool of
STREAMS, taken in turn, so the chunks of a round run at the same time
(a chunk of B problems fills B warps of the card).  The pool is the
device's, shared by every engine of the process, so the allocator's
per-stream caches serve later merges too.

Resident sequence arena (register_contigs; run_merge under GAM_ARENA=1):
the registered contigs are packed 4 bits a code into one arena, copied
once to each device.  On the device-traceback paths a problem whose two
sequences are registered (or are reverse complements of registered
ones, io.fasta.rc_source) ships 12 int32 columns instead of its windows,
and the gather kernel (ops.arena_gather) cuts the same packed windows
from the arena on the chunk's stream; the forward and the walk then run
unchanged.  Problems with an unregistered sequence go through the
window upload in the same call; under the host traceback no problem
takes the arena (as in the JAX engine).

Several devices (the JAX engine's mesh): each chunk's padded batch B is
a multiple of the device count n (per-device padding, `_pad_batch`),
and shard d, rows [d*B/n, (d+1)*B/n), is uploaded to device d and runs
there on that device's stream pool, on all three paths; the results
are fetched shard by shard in order.  A shard with no live problem is
not dispatched, while the `util` counters keep the JAX engine's B.

Host traceback (the JAX engine's _run_chunk): per chunk the row forward
runs on the device, its direction words, last row and diagonal are
fetched, and find-max and the walk run on the host (the C++ walk of
native/gamio.cc, or its Python twin under GAM_NO_NATIVE), giving full
edit strings.

The engine takes its torch.device(s) from the caller; CPU tensors run
the kernels' plain PyTorch versions.

Spans (utils.metrics.span, host operators in a running torch.profiler
session, on the trace's clock): `bsw.align_many` a call, holding
`bsw.prepare` (clip, bucket, chunk plan) and per chunk `bsw.pack`,
`bsw.upload`, `bsw.launch`, `bsw.fetch`, then `bsw.decode` (device
traceback) or `bsw.host_walk` (host traceback); over several devices
the device traceback's `bsw.upload` and `bsw.launch` come a shard.  While a profiler
records, each call also appends (live problems, chunks) to `call_log`,
the attributes of its `bsw.align_many` span, in call order.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..device import as_devices
from ..utils.metrics import span
from . import arena_gather, bsw_antidiag, bsw_row, bsw_walk
from .arena_gather import gather_windows
from .bsw_antidiag import a_width, antidiag_dims, forward_antidiag
from .bsw_host import (
    _pack4,
    _PackedDirs,
    _pad_dim,
    _prepare,
    _traceback_from_dirs,
    _traceback_native,
)
from .bsw_ref import DEFAULT_BAND_SIZE, bsw_align
from .bsw_row import forward_row
from .bsw_walk import ANTIDIAG, ITERS, ROW, find_max_torch, walk
from .editops import MATCH, Alignment


def align_oracle(problems, band: int = DEFAULT_BAND_SIZE) -> list[Alignment]:
    """bsw_ref.bsw_align, the exact host aligner of merge --device oracle,
    on align_many's problem tuples: the results BswEngine must equal."""
    return [bsw_align(*pr, band=band) for pr in problems]


class BswEngine:
    """align_one / align_many over (a, begin_a, end_a, b, begin_b, end_b
    [, force_start, force_end]) problems, returning exact
    ops.editops.Alignment values (bsw_ref.bsw_align's results).

    device: a torch.device, or a sequence of them to shard each chunk
    over (the JAX engine's mesh); with n devices the default max_batch
    of 64 becomes 64*n, as there.
    fetch: "lean" ships the walk summary only (Alignment.lean), "edits"
    the edit string too, "auto" = lean on CUDA, edits on the CPU; the
    host traceback always gives edit strings.
    kernel: "row" runs the row-form forward, anything else the
    anti-diagonal one; "auto" reads GAM_KERNEL, as the JAX engine does.
    traceback: "device", "host" or "auto".  "auto" is "device" on CUDA
    and on the CPU alike; the JAX engine's "auto" picks the host walk on
    the CPU, where its Pallas kernels run slowly in interpret mode, which
    does not hold for the plain versions here.  Results are identical
    either way.  The host walkers read row-major words, so "host" always
    runs the row-form forward.
    """

    STREAMS = 4  # CUDA streams the chunks of a round are spread over
    _POOLS: dict = {}  # device -> its CUDA streams, made at first use

    def __init__(self, device, band: int = DEFAULT_BAND_SIZE,
                 max_batch: int = 64, hbm_budget_bytes: int = 2 << 30,
                 fetch: str = "auto", kernel: str = "auto",
                 traceback: str = "auto"):
        if fetch not in ("lean", "edits", "auto"):
            raise ValueError(f"fetch {fetch!r}: lean, edits or auto")
        if traceback not in ("device", "host", "auto"):
            raise ValueError(f"traceback {traceback!r}: device, host or auto")
        self.devices = as_devices(device)
        self.device = self.devices[0]
        if len(self.devices) > 1 and max_batch == 64:
            max_batch *= len(self.devices)
        self.band = band
        self.max_batch = max_batch
        self.hbm_budget = hbm_budget_bytes
        self.fetch = fetch
        self.kernel = (os.environ.get("GAM_KERNEL", kernel)
                       if kernel == "auto" else kernel)
        self.traceback = "device" if traceback == "auto" else traceback
        self.cells_aligned = 0  # logical band cells processed (metrics)
        self.bytes_up = 0       # host->device payload bytes (metrics)
        self.dispatches = 0
        # ragged-batching utilization: live problems vs padded batch
        # rows, and live DP rows vs padded xw*B rows; the device walk's
        # steps and its iterations (one a step in the plain walk, one a
        # diagonal run of up to 32 word rows in the kernel); the live
        # problems whose forward ran the split instance (a problem over
        # several warps)
        self.util = {"live": 0, "batch": 0, "rows_live": 0,
                     "rows_padded": 0, "walk_steps": 0, "walk_iters": 0,
                     "fwd_split": 0}
        # shards dispatched to each device, by position in self.devices
        self.shard_runs = [0] * len(self.devices)
        # arena chunks and the problems they held (metrics)
        self.arena_chunks = 0
        self.arena_problems = 0
        # (live problems, chunks) of each align_many call made while a
        # torch.profiler session recorded: its bsw.align_many span's
        # attributes, in call order
        self.call_log: list[tuple[int, int]] = []
        # resident sequence arena: id(arr) -> (ofs, len, rev); _seq_keep
        # pins the registered arrays, _seq_refs the reverse-orientation
        # arrays served from them (id-keyed maps must keep keys alive)
        self._seq_map: dict[int, tuple[int, int, int]] = {}
        self._seq_keep: list = []
        self._seq_refs: list = []
        self._arena_len = 0
        self._arena_host: np.ndarray | None = None  # packed, once built
        self._arena_dev: dict = {}  # device -> its copy of the arena
        self._streams: dict = {}  # device -> this engine's STREAMS of the pool
        self._turn = 0

    @classmethod
    def from_reference(cls, ref, device) -> "BswEngine":
        """An engine with a gam_ngs_tpu BswEngine's band, batch, budget,
        fetch, kernel and traceback settings (read as attributes; no JAX
        call)."""
        return cls(device, band=ref.band, max_batch=ref.max_batch,
                   hbm_budget_bytes=ref.hbm_budget, fetch=ref.fetch,
                   kernel=ref.kernel, traceback=ref.traceback)

    @staticmethod
    def kernel_launches() -> dict[str, int]:
        """Launch counts of the CUDA kernels in this process."""
        return {"arena_gather": arena_gather.launches,
                "bsw_antidiag": bsw_antidiag.launches,
                "bsw_row": bsw_row.launches,
                "bsw_walk": bsw_walk.launches}

    def _use_row(self) -> bool:
        return self.kernel == "row" or self.traceback == "host"

    def _lean(self) -> bool:
        if self.fetch == "auto":
            return self.device.type == "cuda"
        return self.fetch == "lean"

    # ---- resident sequence arena (bsw_batch.py:711-777) ---------------

    def register_contigs(self, arrays) -> None:
        """Add contig code arrays to the sequence arena.  Reverse
        orientations are served from the same codes: io.fasta's memoised
        reverse_complement maps an rc array to its base, and the gather
        reads it backwards and complements it."""
        added = False
        for a in arrays:
            if len(a) == 0 or id(a) in self._seq_map:
                continue
            self._seq_map[id(a)] = (self._arena_len, len(a), 0)
            self._seq_keep.append(a)
            self._arena_len += int(len(a))
            added = True
        if added:  # every align_many has fetched its chunks: none reads it
            self._arena_host = None
            self._arena_dev = {}

    def _seq_lookup(self, arr):
        ent = self._seq_map.get(id(arr))
        if ent is not None:
            return ent
        from ..io.fasta import rc_source

        src = rc_source(arr)
        if src is not None:
            base = self._seq_map.get(id(src))
            if base is not None:
                ent = (base[0], base[1], base[2] ^ 1)
                self._seq_map[id(arr)] = ent
                self._seq_refs.append(arr)
                return ent
        return None

    def _arena_packed(self, dev: torch.device) -> torch.Tensor:
        """The arena on `dev`: packed once (two codes a byte, padded to a
        multiple of 1 M codes) and counted once in bytes_up, then copied
        once to each device, before any chunk stream reads it."""
        if self._arena_host is None:
            tp = max(1 << 20, -(-self._arena_len // (1 << 20)) << 20)
            flat = np.zeros(tp, np.uint8)
            for a in self._seq_keep:
                ofs, ln, _rev = self._seq_map[id(a)]
                flat[ofs:ofs + ln] = a
            self._arena_host = (flat[0::2] | (flat[1::2] << 4)).astype(
                np.uint8)
            self.bytes_up += self._arena_host.nbytes  # one-time upload
        arena = self._arena_dev.get(dev)
        if arena is None:
            arena = torch.from_numpy(self._arena_host).to(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self._arena_dev[dev] = arena
        return arena

    def align_one(self, a, begin_a, end_a, b, begin_b, end_b,
                  force_start=False, force_end=False) -> Alignment:
        return self.align_many(
            [(a, begin_a, end_a, b, begin_b, end_b, force_start, force_end)]
        )[0]

    def align_many(self, problems) -> list[Alignment]:
        with span("bsw.align_many"):
            with span("bsw.prepare"):
                preps, chunks, out = self._plan(problems)
            if torch.autograd._profiler_enabled():
                self.call_log.append((sum(len(c[0]) for c in chunks),
                                      len(chunks)))
            if self.traceback == "host":
                for chunk, xw, _arena in chunks:
                    self._run_chunk(chunk, preps, xw, out)
                return out  # type: ignore[return-value]
            # dispatch every chunk before fetching any result: the device
            # queue stays full while the host packs the next chunk
            pending = [self._dispatch(chunk, preps, xw, arena_ok)
                       for chunk, xw, arena_ok in chunks]
            for pend in pending:
                self._collect(pend, preps, out)
            return out  # type: ignore[return-value]

    def _plan(self, problems):
        """Clip every problem (_prepare), bucket the live ones by window
        and arena use, and cut the buckets into chunks: (preps, chunks of
        (indices, xw, arena_ok), out with the empty problems' answers)."""
        preps = [_prepare(*pr[:6],
                          pr[6] if len(pr) > 6 else False,
                          pr[7] if len(pr) > 7 else False,
                          self.band) for pr in problems]
        out: list[Alignment | None] = [None] * len(preps)
        # the arena serves the device-traceback paths only (the JAX
        # engine's fused path)
        use_arena = bool(self._seq_map) and self.traceback != "host"
        buckets: dict[tuple[int, bool], list[int]] = {}
        for i, p in enumerate(preps):
            if p.empty:
                out[i] = Alignment()
                continue
            if use_arena:
                p.a_arena = self._seq_lookup(p.a)
                p.b_arena = self._seq_lookup(p.b)
            arena_ok = p.a_arena is not None and p.b_arena is not None
            buckets.setdefault((_pad_dim(p.x_size), arena_ok), []).append(i)

        # the JAX engine's chunking bound, kept so chunks (and the
        # fill counters) match it
        YP = -(-(2 * self.band + 2) // 128) * 128
        chunks: list[tuple[list[int], int, bool]] = []
        for (xw, arena_ok), idxs in buckets.items():
            aw = antidiag_dims(xw, self.band)[3]
            per_problem = xw * YP + aw + 5 * xw
            bmax = max(1, min(self.max_batch,
                              self.hbm_budget // max(per_problem, 1)))
            for k in range(0, len(idxs), bmax):
                chunks.append((idxs[k:k + bmax], xw, arena_ok))
        return preps, chunks, out

    def _pad_batch(self, n: int) -> int:
        """Batch sizes quantised to {8, 16, 32, 64, ...} a device, times
        the device count; the dummy rows are empty problems the host
        ignores."""
        n_dev = len(self.devices)
        per = -(-n // n_dev)
        b = 8
        while b < per:
            b *= 2
        return b * n_dev

    def _shards(self, B: int, live: int) -> list[tuple[int, slice]]:
        """(device position, rows) of each shard of a B-row chunk that
        holds one of its `live` leading problems: shard d is rows
        [d*B/n, (d+1)*B/n)."""
        per = B // len(self.devices)
        return [(d, slice(d * per, (d + 1) * per))
                for d in range(len(self.devices)) if d * per < live]

    def _count_chunk(self, n_live: int, B: int, xw: int, x_sum: int):
        self.cells_aligned += x_sum * (2 * self.band + 1)
        self.util["live"] += n_live
        self.util["batch"] += B
        self.util["rows_live"] += x_sum
        self.util["rows_padded"] += B * xw

    def _pack_chunk(self, chunk, preps, xw):
        aw = a_width(xw, self.band)
        B = self._pad_batch(len(chunk))
        a_win = np.full((B, aw), 255, np.uint8)
        b_win = np.zeros((B, xw), np.uint8)
        # begin_a, end_a, a_len, x_size, force_start, force_end
        scal = np.zeros((6, B), np.int32)
        for t, i in enumerate(chunk):
            p = preps[i]
            a_win[t, :len(p.a_win)] = p.a_win
            b_win[t, :len(p.b_win)] = p.b_win
            scal[:, t] = (p.begin_a, p.end_a, len(p.a), p.x_size,
                          int(p.force_start), int(p.force_end))
        self._count_chunk(len(chunk), B, xw, int(scal[3].sum()))
        return _pack4(a_win), _pack4(b_win), scal

    def _pack_chunk_arena(self, chunk, preps, xw):
        """The (12, B) int32 columns of an arena chunk
        (bsw_batch.py::_pack_chunk_arena): a_ofs, a_len, a_rev, begin_a,
        end_a, b_ofs, b_len, b_rev, begin_b, x_size, force_start,
        force_end."""
        B = self._pad_batch(len(chunk))
        cols = np.zeros((12, B), np.int32)
        for t, i in enumerate(chunk):
            p = preps[i]
            cols[:, t] = (*p.a_arena, p.begin_a, p.end_a, *p.b_arena,
                          p.begin_b, p.x_size, int(p.force_start),
                          int(p.force_end))
        self._count_chunk(len(chunk), B, xw, int(cols[9].sum()))
        return cols

    def _pack_and_count(self, chunk, preps, xw, arena_ok):
        """Pack one chunk and count its upload: (arrays, B)."""
        with span("bsw.pack"):
            self.dispatches += 1
            if arena_ok:
                cols = self._pack_chunk_arena(chunk, preps, xw)
                self.bytes_up += 12 * 4 * cols.shape[1]
                self.arena_chunks += 1
                self.arena_problems += len(chunk)
                return (cols,), cols.shape[1]
            a_pk, b_pk, scal = self._pack_chunk(chunk, preps, xw)
            self.bytes_up += a_pk.nbytes + b_pk.nbytes + scal.nbytes
            return (a_pk, b_pk, scal), a_pk.shape[0]

    def _shard_inputs(self, arrays, rows, d: int, xw: int, arena=None):
        """One shard's forward inputs on device d: (a_pk, b_pk, begin_a,
        end_a, a_len, x_size, force_start, force_end).  An arena shard
        uploads its columns and gathers its windows from `arena`, the
        arena's copy on device d."""
        dev = self.devices[d]
        self.shard_runs[d] += 1
        if arena is not None:
            cols = torch.from_numpy(np.ascontiguousarray(
                arrays[0][:, rows])).to(dev)
            a_d, b_d = gather_windows(arena, cols, self.band,
                                      a_width(xw, self.band), xw)
            return (a_d, b_d, cols[3], cols[4], cols[1], cols[9], cols[10],
                    cols[11])
        a_pk, b_pk, scal = arrays
        a_d, b_d, s = (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                       for v in (a_pk[rows], b_pk[rows], scal[:, rows]))
        return (a_d, b_d, *s.unbind(0))

    def _stream(self, d: int, turn: int):
        """Shard d's stream for the chunk of this turn, from device d's
        pool on CUDA (else a context that changes nothing).  The shards of
        one chunk take consecutive streams, so shards that share a device
        (a device named twice) do not queue behind one another."""
        dev = self.devices[d]
        if dev.type != "cuda":
            return None, contextlib.nullcontext()
        streams = self._streams.get(dev)
        if streams is None:
            pool = BswEngine._POOLS.setdefault(dev, [])
            while len(pool) < self.STREAMS:
                pool.append(torch.cuda.Stream(dev))
            streams = self._streams[dev] = pool[:self.STREAMS]
        stream = streams[(turn * len(self.devices) + d) % len(streams)]
        return stream, torch.cuda.stream(stream)

    def _dispatch(self, chunk, preps, xw, arena_ok=False):
        """Pack one chunk and queue each live shard's upload (or arena
        gather) and its two kernels on the shard's stream; returns what
        _collect needs without waiting for the device.  The shards'
        tensors are made on their streams too."""
        band = self.band
        lmax = -(-(2 * xw + 2 * band + 8) // 4) * 4
        lean = self._lean()
        row = self._use_row()
        arrays, B = self._pack_and_count(chunk, preps, xw, arena_ok)
        turn = self._turn
        self._turn += 1
        shards = []
        for d, rows in self._shards(B, len(chunk)):
            # the arena's copy is made before any stream of the device
            # reads it
            arena = (self._arena_packed(self.devices[d]) if arena_ok
                     else None)
            stream, ctx = self._stream(d, turn)
            with ctx:
                with span("bsw.upload"):
                    a_d, b_d, begin_a, end_a, a_len, x_size, fstart, fend = \
                        self._shard_inputs(arrays, rows, d, xw, arena)
                with span("bsw.launch"):
                    forward = forward_row if row else forward_antidiag
                    split0 = bsw_antidiag.split_launches
                    dirs, last_row, diag = forward(
                        a_d, b_d, begin_a, end_a, a_len, x_size, fstart,
                        band)
                    if bsw_antidiag.split_launches != split0:
                        self.util["fwd_split"] += (
                            min(rows.stop, len(chunk)) - rows.start)
                    summary, edits = walk(dirs, a_d, b_d, begin_a, end_a,
                                          x_size, fend, last_row, diag, band,
                                          lmax, with_edits=not lean,
                                          layout=ROW if row else ANTIDIAG)
            shards.append((summary, edits, stream))
        return chunk, shards

    def _collect(self, pend, preps, out):
        chunk, shards = pend
        parts, e_parts = [], []
        with span("bsw.fetch"):
            for summary, edits, stream in shards:
                # the fetches queue on the shard's stream, behind its walk
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    parts.append(summary.cpu().numpy())  # the fetch (lean)
                    if edits is not None:
                        e_parts.append(edits.cpu().numpy())
        s = np.concatenate(parts, axis=1)
        self.util["walk_steps"] += int(s[2].sum())
        self.util["walk_iters"] += int(s[ITERS].sum())
        with span("bsw.decode"):
            self._decode(chunk, preps, s,
                         np.concatenate(e_parts, axis=0) if e_parts else None,
                         out)

    def _decode(self, chunk, preps, s, e, out):
        """Alignment values of a chunk from its (14, B) summary and, with
        edits fetched, its (B, L) edit codes."""
        (xf, yf, cnt, matches, gapa, gapb, hasm, fmx, fmy, lmx, lmy,
         score, found) = (s[k] for k in range(13))
        band = self.band
        if e is None:
            for t, i in enumerate(chunk):
                p = preps[i]
                if not found[t]:
                    out[i] = Alignment()
                    continue
                n = int(cnt[t])
                ba = int(p.begin_a + xf[t] + yf[t] - band) + 1
                bb = int(p.begin_b + xf[t]) + 1
                hom = 0.0 if n == 0 else int(matches[t]) * 100.0 / n
                if hasm[t]:
                    fm = (True, (int(p.begin_a + fmx[t] + fmy[t] - band),
                                 int(p.begin_b + fmx[t])))
                    lm = (True, (int(p.begin_a + lmx[t] + lmy[t] - band),
                                 int(p.begin_b + lmx[t])))
                else:
                    # reference no-match fallbacks (my_alignment.cc:168/
                    # :229): first -> fully-advanced position, last ->
                    # the alignment begin
                    fm = (False, (ba + n - int(gapa[t]),
                                  bb + n - int(gapb[t])))
                    lm = (False, (ba, bb))
                out[i] = Alignment(
                    begin_a=ba, begin_b=bb, a_size=len(p.a),
                    b_size=len(p.b), score=int(score[t]), homology=hom,
                    lean=(n, int(matches[t]), fm, lm))
            return
        for t, i in enumerate(chunk):
            p = preps[i]
            if not found[t]:
                out[i] = Alignment()
                continue
            n = int(cnt[t])
            codes = e[t, :n][::-1]
            m = int((codes == MATCH).sum())
            x = int(xf[t])
            pos = p.begin_a + x + int(yf[t]) - band
            out[i] = Alignment(
                begin_a=pos + 1, begin_b=p.begin_b + x + 1,
                a_size=len(p.a), b_size=len(p.b), score=int(score[t]),
                homology=0.0 if n == 0 else m * 100.0 / n,
                edits=np.ascontiguousarray(codes))

    def _run_chunk(self, chunk, preps, xw, out):
        """Host traceback of one chunk: the row forward on each shard's
        device, one fetch each of its directions, last row and diagonal,
        then find-max (find_max_torch on the fetched tensors) and the
        walk on the host (bsw_batch.py::_run_chunk)."""
        band = self.band
        arrays, B = self._pack_and_count(chunk, preps, xw, False)
        shards = self._shards(B, len(chunk))
        with span("bsw.upload"):
            inputs = [self._shard_inputs(arrays, rows, d, xw)
                      for d, rows in shards]
        with span("bsw.launch"):
            queued = [forward_row(a_d, b_d, begin_a, end_a, a_len, x_size,
                                  fstart, band)
                      for a_d, b_d, begin_a, end_a, a_len, x_size, fstart,
                      _fend in inputs]
        with span("bsw.fetch"):
            dirs = np.concatenate([q[0].cpu().numpy() for q in queued])
            last_row = torch.cat([q[1].cpu() for q in queued])
            diag = torch.cat([q[2].cpu() for q in queued])
        with span("bsw.host_walk"):
            self._host_walk(chunk, preps, dirs, last_row, diag, out)

    def _host_walk(self, chunk, preps, dirs, last_row, diag, out):
        """Find-max and the walk of a chunk on the host, from its fetched
        directions, last row and diagonal."""
        band = self.band
        n = len(chunk)
        sc = [torch.tensor([getattr(preps[i], f) for i in chunk],
                           dtype=torch.int32)
              for f in ("begin_a", "end_a", "x_size", "force_end")]
        found_max = find_max_torch(last_row[:n], diag[:n], *sc, band)
        for t, (i, max_i, max_j, max_score, found) in enumerate(
                zip(chunk, *(v.tolist() for v in found_max))):
            p = preps[i]
            if not found:
                out[i] = Alignment()
                continue
            res = _traceback_native(dirs, t, p, band, max_i, max_j)
            if res is not None:
                edits, matches, x, pos = res
            else:
                edits, matches, x, pos = _traceback_from_dirs(
                    _PackedDirs(dirs[t]), p, band, max_i, max_j)
            homology = 0.0 if not edits else matches * 100.0 / len(edits)
            out[i] = Alignment(
                begin_a=pos + 1, begin_b=p.begin_b + x + 1,
                a_size=len(p.a), b_size=len(p.b), score=max_score,
                homology=homology, edits=np.array(edits, np.uint8))
