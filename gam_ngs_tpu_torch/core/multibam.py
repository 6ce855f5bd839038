"""Multi-library alignment store — the MultiBamReader replacement.

Reference: lib/src/bam/MultiBamReader.cc.  Instead of a
k-way streaming merge with per-reader mutexes, all libraries are decoded
once into columnar tables; the coordinate-merged view is a lexicographic
permutation (ref_id, pos, lib, within-lib order), which reproduces the
reference's merge order exactly for coordinate-sorted inputs (ties go to
the lowest library index, MultiBamReader.cc:330).  Region queries used by
edge weighting / z-scores become binary-searched slices of the per-library
tables (sorted by coordinate) — no BAM re-reads, no locks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io import bamlist, isize as isize_io
from ..io.bam import (
    AlignmentTable,
    BamFile,
    empty_table,
    read_bam,
    read_bam_header,
    read_bam_runs,
)
from . import stats as stats_mod

MIN_ISIZE = 100       # MultiBamReader.hpp:44
MAX_ISIZE = 1000000   # MultiBamReader.hpp:45


@dataclass
class MultiBam:
    files: list[BamFile]
    min_insert: list[int]
    max_insert: list[int]
    isize_mean: list[float] = field(default_factory=list)
    isize_std: list[float] = field(default_factory=list)
    coverage: list[float] = field(default_factory=list)

    # per-library coordinate sort permutations (for region queries)
    # + the coord-sorted (ref_id, pos) columns (rebuilt together)
    _coord_order: list[np.ndarray] = field(default_factory=list)
    _coord_cols: list[tuple] = field(default_factory=list)

    @staticmethod
    def open(bam_list_file: str,
             ref_range: tuple[int, int] | None = None) -> "MultiBam":
        """ref_range=(lo, hi) decodes only records on contigs
        [lo, hi) per library — the multi-host create shard path."""
        names, mins, maxs = bamlist.load_bam_file_names(bam_list_file)
        if len(names) == 0:
            raise ValueError(f"empty BAM list: {bam_list_file}")
        files = [read_bam(n, ref_range=ref_range) for n in names]
        # header consistency: reference uses the first reader's RefVector
        mb = MultiBam(files, list(mins), list(maxs))
        mb.set_min_max_insert_sizes(mins, maxs)
        return mb

    @staticmethod
    def open_deferred(bam_list_file: str) -> "MultiBam":
        """Headers only — tables stay empty until load_ref_runs.

        The multi-host merge path opens deferred, computes graph
        partitioning + ownership from the blocks file alone, then
        decodes only the contig runs its own partitions touch."""
        names, mins, maxs = bamlist.load_bam_file_names(bam_list_file)
        if len(names) == 0:
            raise ValueError(f"empty BAM list: {bam_list_file}")
        files = [BamFile(read_bam_header(n), empty_table(), n)
                 for n in names]
        mb = MultiBam(files, list(mins), list(maxs))
        mb.set_min_max_insert_sizes(mins, maxs)
        mb._deferred = True
        return mb

    def load_ref_runs(self, ref_runs: list[tuple[int, int]]) -> None:
        """Decode each library restricted to the union of the
        ascending, disjoint contig-id runs (no-op on a non-deferred
        store; a second call re-decodes with the new runs)."""
        if not getattr(self, "_deferred", False):
            return
        for i, f in enumerate(self.files):
            self.files[i] = read_bam_runs(f.path, ref_runs) if ref_runs \
                else BamFile(f.header, empty_table(), f.path)
        self._coord_order = []

    def load_all(self) -> None:
        """Decode every library fully (deferred stores only)."""
        if not getattr(self, "_deferred", False):
            return
        self.files = [read_bam(f.path) for f in self.files]
        self._deferred = False
        self._coord_order = []

    @property
    def size(self) -> int:
        return len(self.files)

    def filenames(self) -> list[str]:
        return [f.path for f in self.files]

    def set_min_max_insert_sizes(self, mins, maxs) -> None:
        """MultiBamReader::setMinMaxInsertSizes (.cc:149) — note the
        reference's guard tests the CURRENT values (the defaults, always
        positive), so the provided bounds are always taken verbatim."""
        self.min_insert = list(mins)
        self.max_insert = list(maxs)

    @property
    def ref_names(self) -> list[str]:
        return self.files[0].header.ref_names

    @property
    def ref_lengths(self) -> list[int]:
        return self.files[0].header.ref_lengths

    @property
    def asm_size(self) -> int:
        return int(sum(self.ref_lengths))

    # ---- stats ----
    def compute_statistics(self, require_paired_flag: bool) -> None:
        """Per-library isize/coverage stats.

        require_paired_flag=True replicates the gam-create path (stats
        updated through GetNextAlignment, which also checks IsPaired);
        False replicates MultiBamReader::computeStatistics.
        """
        self.isize_mean, self.isize_std, self.coverage = [], [], []
        for i, f in enumerate(self.files):
            m, s, c = stats_mod.library_stats(
                f.table, self.asm_size, self.min_insert[i], self.max_insert[i],
                require_paired_flag,
            )
            self.isize_mean.append(m)
            self.isize_std.append(s)
            self.coverage.append(c)

    def write_stats_to_file(self, path: str) -> None:
        isize_io.write_isize(path, self.filenames(), self.isize_mean,
                             self.isize_std, self.coverage)

    def read_stats_from_file(self, path: str) -> None:
        m, s, c = isize_io.read_isize(path, self.filenames())
        self.isize_mean, self.isize_std, self.coverage = m, s, c

    def get_glob_coverage(self) -> float:
        return float(sum(self.coverage))

    # ---- merged view ----
    def merged_indices(self) -> tuple[np.ndarray, np.ndarray]:
        """(lib, row) indices in coordinate-merged order.

        Restricted-to-mapped-record order matches the reference's k-way
        merge (unmapped ref_id=-1 tail records interleave differently but
        are filtered by every consumer).
        """
        libs = np.concatenate([
            np.full(len(f.table), i, np.int32) for i, f in enumerate(self.files)
        ]) if self.files else np.zeros(0, np.int32)
        rows = np.concatenate([
            np.arange(len(f.table), dtype=np.int64) for f in self.files
        ]) if self.files else np.zeros(0, np.int64)
        ref = np.concatenate([f.table.ref_id for f in self.files])
        pos = np.concatenate([f.table.pos for f in self.files])
        order = np.lexsort((rows, libs, pos, ref))
        return libs[order], rows[order]

    def merged_table(self) -> tuple[AlignmentTable, np.ndarray]:
        """Concatenated table in merged coordinate order + lib column."""
        libs, rows = self.merged_indices()
        offs = np.cumsum([0] + [len(f.table) for f in self.files])
        flat = rows + offs[libs]

        def cat(name):
            return np.concatenate([getattr(f.table, name) for f in self.files])[flat]

        t = AlignmentTable(**{k: cat(k) for k in (
            "ref_id", "pos", "end_pos", "flag", "l_seq", "mate_ref_id",
            "mate_pos", "nh", "xt", "name_h1", "name_h2")})
        return t, libs

    # ---- region queries ----
    def _ensure_coord_order(self) -> None:
        if not self._coord_order:
            self._coord_order = [
                np.lexsort((np.arange(len(f.table)), f.table.pos, f.table.ref_id))
                for f in self.files
            ]
            # coord-sorted (ref_id, pos) columns, materialized ONCE:
            # re-gathering them per region query made the partition
            # phase O(edges x rows) — two full-table gathers per call,
            # ~32 s of the 50 Mbp merge before this cache
            self._coord_cols = [
                (np.ascontiguousarray(f.table.ref_id[order]),
                 np.ascontiguousarray(f.table.pos[order]))
                for f, order in zip(self.files, self._coord_order)
            ]

    def region_rows(self, lib: int, ref_id: int, left: int, right: int) -> np.ndarray:
        """Row indices of library `lib` with pos in BAI-region semantics.

        BamReader::SetRegion(ref, left, ref, right) yields records with
        pos in [left, right), plus records starting before `left` whose
        CIGAR end overlaps it (BamRandomAccessController_p.cpp:60-99).
        Records are returned in coordinate order.
        """
        self._ensure_coord_order()
        t = self.files[lib].table
        order = self._coord_order[lib]
        ref_sorted, pos_sorted = self._coord_cols[lib]
        # needles must match the haystack dtype: a python-int needle
        # makes numpy cast the WHOLE sorted column to int64 per call
        # (measured 2 ms vs 4 us on 4M rows)
        ref_id = ref_sorted.dtype.type(ref_id)
        lo = np.searchsorted(ref_sorted, ref_id, "left")
        hi = np.searchsorted(ref_sorted, ref_id, "right")
        # pos < right
        cut = lo + np.searchsorted(pos_sorted[lo:hi],
                                   pos_sorted.dtype.type(right), "left")
        cand = order[lo:cut]
        # pos >= left, or an earlier start whose end overlaps left
        return cand[(t.pos[cand] >= left) | (t.end_pos[cand] > left)]

    def region_range(self, lib: int, ref_id: int, left: int,
                     right: int) -> tuple[int, int]:
        """Coordinate-order row range [a, b) of library `lib` with
        pos in [left, right).

        The device-resident edge-weight path (ops.region_score) keys
        jobs by these ranges into the coord-sorted column arena instead
        of materializing per-job row copies.  Rows that region_rows
        additionally returns (pos < left with overlapping end) are
        excluded here — they fail the kernel's `pos >= s1` range gate
        (the reference's `start_read < s1 -> continue`,
        CompactAssemblyGraph.cc:430) and can never contribute."""
        self._ensure_coord_order()
        ref_sorted, pos_sorted = self._coord_cols[lib]
        # typed needles: see region_rows (python-int needles cast the
        # whole 4M-row column per call)
        pt = pos_sorted.dtype.type
        lo = np.searchsorted(ref_sorted, ref_sorted.dtype.type(ref_id),
                             "left")
        hi = np.searchsorted(ref_sorted, ref_sorted.dtype.type(ref_id),
                             "right")
        a = lo + np.searchsorted(pos_sorted[lo:hi], pt(left), "left")
        b = lo + np.searchsorted(pos_sorted[lo:hi], pt(right), "left")
        return int(a), int(b)

    def coord_order(self, lib: int) -> np.ndarray:
        self._ensure_coord_order()
        return self._coord_order[lib]
