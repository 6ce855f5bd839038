"""Batched banded Smith-Waterman engine on a torch device.

The counterpart of gam_ngs_tpu/ops/bsw_batch.py::BswEngine: problems are
clipped by `_prepare`, bucketed by the window buckets (`_pad_dim`),
chunked by max_batch and the device-memory budget, and uploaded as
4-bit packed windows.  Each chunk runs a forward kernel: the
anti-diagonal one (ops.bsw_antidiag) or, with kernel="row"
(GAM_KERNEL=row) or the host traceback, the row-form one (ops.bsw_row).

Device traceback: the find-max + walk kernel (ops.bsw_walk) follows the
forward on the device.  Every chunk is dispatched before any result is
fetched; each chunk's fetch is one (13, B) int32 summary (`lean`), or
that plus the edit codes (`edits`).  The direction words stay on the
device and are freed once the walk is queued.  On CUDA each chunk's
upload, kernels and fetch run on one stream of a fixed pool of
STREAMS, taken in turn, so the chunks of a round run at the same time
(a chunk of B problems fills B warps of the card).  The pool is the
device's, shared by every engine of the process, so the allocator's
per-stream caches serve later merges too.

Host traceback (the JAX engine's _run_chunk): per chunk the row forward
runs on the device, its direction words, last row and diagonal are
fetched, and find-max and the walk run on the host (the C++ walk of
native/gamio.cc, or its Python twin under GAM_NO_NATIVE), giving full
edit strings.

The engine takes its torch.device from the caller; CPU tensors run the
kernels' plain PyTorch versions.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from . import bsw_antidiag, bsw_row, bsw_walk
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
from .bsw_walk import ANTIDIAG, ROW, find_max_torch, walk
from .editops import MATCH, Alignment


def align_oracle(problems, band: int = DEFAULT_BAND_SIZE) -> list[Alignment]:
    """bsw_ref.bsw_align, the exact host aligner of merge --device oracle,
    on align_many's problem tuples: the results BswEngine must equal."""
    return [bsw_align(*pr, band=band) for pr in problems]


class BswEngine:
    """align_one / align_many over (a, begin_a, end_a, b, begin_b, end_b
    [, force_start, force_end]) problems, returning exact
    ops.editops.Alignment values (bsw_ref.bsw_align's results).

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

    def __init__(self, device: torch.device, band: int = DEFAULT_BAND_SIZE,
                 max_batch: int = 64, hbm_budget_bytes: int = 2 << 30,
                 fetch: str = "auto", kernel: str = "auto",
                 traceback: str = "auto"):
        if fetch not in ("lean", "edits", "auto"):
            raise ValueError(f"fetch {fetch!r}: lean, edits or auto")
        if traceback not in ("device", "host", "auto"):
            raise ValueError(f"traceback {traceback!r}: device, host or auto")
        self.device = torch.device(device)
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
        # rows, and live DP rows vs padded xw*B rows
        self.util = {"live": 0, "batch": 0, "rows_live": 0,
                     "rows_padded": 0}
        self._streams: list = []  # this engine's STREAMS of the pool
        self._turn = 0

    @classmethod
    def from_reference(cls, ref, device: torch.device) -> "BswEngine":
        """An engine with a gam_ngs_tpu BswEngine's band, batch, budget,
        fetch, kernel and traceback settings (read as attributes; no JAX
        call)."""
        return cls(device, band=ref.band, max_batch=ref.max_batch,
                   hbm_budget_bytes=ref.hbm_budget, fetch=ref.fetch,
                   kernel=ref.kernel, traceback=ref.traceback)

    @staticmethod
    def kernel_launches() -> dict[str, int]:
        """Launch counts of the CUDA kernels in this process."""
        return {"bsw_antidiag": bsw_antidiag.launches,
                "bsw_row": bsw_row.launches,
                "bsw_walk": bsw_walk.launches}

    def _use_row(self) -> bool:
        return self.kernel == "row" or self.traceback == "host"

    def _lean(self) -> bool:
        if self.fetch == "auto":
            return self.device.type == "cuda"
        return self.fetch == "lean"

    def align_one(self, a, begin_a, end_a, b, begin_b, end_b,
                  force_start=False, force_end=False) -> Alignment:
        return self.align_many(
            [(a, begin_a, end_a, b, begin_b, end_b, force_start, force_end)]
        )[0]

    def align_many(self, problems) -> list[Alignment]:
        preps = [_prepare(*pr[:6],
                          pr[6] if len(pr) > 6 else False,
                          pr[7] if len(pr) > 7 else False,
                          self.band) for pr in problems]
        out: list[Alignment | None] = [None] * len(preps)
        buckets: dict[int, list[int]] = {}
        for i, p in enumerate(preps):
            if p.empty:
                out[i] = Alignment()
            else:
                buckets.setdefault(_pad_dim(p.x_size), []).append(i)

        # the JAX engine's chunking bound, kept so chunks (and the
        # fill counters) match it
        YP = -(-(2 * self.band + 2) // 128) * 128
        chunks: list[tuple[list[int], int]] = []
        for xw, idxs in buckets.items():
            aw = antidiag_dims(xw, self.band)[3]
            per_problem = xw * YP + aw + 5 * xw
            bmax = max(1, min(self.max_batch,
                              self.hbm_budget // max(per_problem, 1)))
            for k in range(0, len(idxs), bmax):
                chunks.append((idxs[k:k + bmax], xw))

        if self.traceback == "host":
            for chunk, xw in chunks:
                self._run_chunk(chunk, preps, xw, out)
            return out  # type: ignore[return-value]
        # dispatch every chunk before fetching any result: the device
        # queue stays full while the host packs the next chunk
        pending = [self._dispatch(chunk, preps, xw) for chunk, xw in chunks]
        for pend in pending:
            self._collect(pend, preps, out)
        return out  # type: ignore[return-value]

    @staticmethod
    def _pad_batch(n: int) -> int:
        """Batch sizes quantised to {8, 16, 32, 64, ...}; the dummy rows
        are empty problems the host ignores."""
        b = 8
        while b < n:
            b *= 2
        return b

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
        x_sum = int(scal[3].sum())
        self.cells_aligned += x_sum * (2 * self.band + 1)
        self.util["live"] += len(chunk)
        self.util["batch"] += B
        self.util["rows_live"] += x_sum
        self.util["rows_padded"] += B * xw
        return _pack4(a_win), _pack4(b_win), scal

    def _upload(self, chunk, preps, xw):
        """Pack and upload one chunk: (a_pk, b_pk, (6,) scalar rows)."""
        a_pk, b_pk, scal = self._pack_chunk(chunk, preps, xw)
        self.bytes_up += a_pk.nbytes + b_pk.nbytes + scal.nbytes
        self.dispatches += 1
        dev = self.device
        return (torch.from_numpy(a_pk).to(dev),
                torch.from_numpy(b_pk).to(dev),
                torch.from_numpy(scal).to(dev).unbind(0))

    def _stream(self):
        """The chunk's stream: the next of the pool on CUDA, else a
        context that changes nothing."""
        if self.device.type != "cuda":
            return None, contextlib.nullcontext()
        if not self._streams:
            pool = BswEngine._POOLS.setdefault(self.device, [])
            while len(pool) < self.STREAMS:
                pool.append(torch.cuda.Stream(self.device))
            self._streams = pool[:self.STREAMS]
        stream = self._streams[self._turn % len(self._streams)]
        self._turn += 1
        return stream, torch.cuda.stream(stream)

    def _dispatch(self, chunk, preps, xw):
        """Upload one chunk and queue its two kernels on the chunk's
        stream; returns what _collect needs without waiting for the
        device.  The chunk's tensors are made on that stream too."""
        band = self.band
        lmax = -(-(2 * xw + 2 * band + 8) // 4) * 4
        lean = self._lean()
        row = self._use_row()
        stream, ctx = self._stream()
        with ctx:
            a_d, b_d, (begin_a, end_a, a_len, x_size, fstart, fend) = \
                self._upload(chunk, preps, xw)
            forward = forward_row if row else forward_antidiag
            dirs, last_row, diag = forward(
                a_d, b_d, begin_a, end_a, a_len, x_size, fstart, band)
            summary, edits = walk(dirs, a_d, b_d, begin_a, end_a, x_size,
                                  fend, last_row, diag, band, lmax,
                                  with_edits=not lean,
                                  layout=ROW if row else ANTIDIAG)
        return chunk, summary, edits, stream

    def _collect(self, pend, preps, out):
        chunk, summary, edits, stream = pend
        # the fetches queue on the chunk's stream, behind its walk
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            s = summary.cpu().numpy()  # the one device->host fetch (lean)
            e = None if edits is None else edits.cpu().numpy()
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
        """Host traceback of one chunk: the row forward on the device,
        one fetch each of its directions, last row and diagonal, then
        find-max (find_max_torch on the fetched tensors) and the walk on
        the host (bsw_batch.py::_run_chunk)."""
        band = self.band
        a_d, b_d, (begin_a, end_a, a_len, x_size, fstart, _fend) = \
            self._upload(chunk, preps, xw)
        dirs, last_row, diag = forward_row(
            a_d, b_d, begin_a, end_a, a_len, x_size, fstart, band)
        dirs = dirs.cpu().numpy()
        n = len(chunk)
        sc = [torch.tensor([getattr(preps[i], f) for i in chunk],
                           dtype=torch.int32)
              for f in ("begin_a", "end_a", "x_size", "force_end")]
        found_max = find_max_torch(last_row.cpu()[:n], diag.cpu()[:n], *sc,
                                   band)
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
