"""Standard .bai index interop.

The reference consumes samtools .bai indexes
(lib/bamtools-2.3.0/src/api/internal/index/BamStandardIndex_p.cpp);
this build's ranged decode seeks via its own one-offset-per-contig
.gidx (native/gamio.cc).  The bridge: a .bai's per-reference first
virtual offset (min over bin chunk starts and non-zero linear-index
offsets — BAM virtual offsets share the .gidx encoding,
coffset << 16 | uoffset) is exactly the .gidx seek point, so an
existing .bai can be translated into a .gidx without touching the BAM.
`read_bam`/`read_bam_runs` call `ensure_gidx` before ranged decodes.
"""

from __future__ import annotations

import os
import struct


def read_bai_first_offsets(bai_path: str) -> list[int]:
    """Per-reference first virtual offset (-1 where no alignments)."""
    with open(bai_path, "rb") as fh:
        data = fh.read()
    if data[:4] != b"BAI\x01":
        raise ValueError(f"{bai_path}: bad BAI magic")
    (n_ref,) = struct.unpack_from("<i", data, 4)
    off = 8
    out = []
    for _ in range(n_ref):
        first = -1
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        for _b in range(n_bin):
            bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            for _c in range(n_chunk):
                beg, _end = struct.unpack_from("<QQ", data, off)
                off += 16
                if bin_id != 37450 and beg > 0:  # skip the metadata bin
                    first = beg if first < 0 else min(first, beg)
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        for _i in range(n_intv):
            (ioff,) = struct.unpack_from("<Q", data, off)
            off += 8
            if ioff > 0:
                first = ioff if first < 0 else min(first, ioff)
        out.append(first)
    return out


def gidx_from_bai(bam_path: str, bai_path: str | None = None) -> bool:
    """Translate <bam>.bai into <bam>.gidx (GAMGIDX2, fingerprinted
    with the BAM's size+mtime like native/gamio.cc's writer).  Returns
    False when no .bai exists or the write fails."""
    bai_path = bai_path or bam_path + ".bai"
    if not os.path.exists(bai_path):
        return False
    try:
        offsets = read_bai_first_offsets(bai_path)
        st = os.stat(bam_path)
        tmp = bam_path + ".gidx.tmp"
        with open(tmp, "wb") as fh:
            fh.write(b"GAMGIDX2")
            fh.write(struct.pack("<q", st.st_size))
            fh.write(struct.pack("<q", st.st_mtime_ns // 1_000_000_000))
            fh.write(struct.pack("<i", len(offsets)))
            fh.write(struct.pack(f"<{len(offsets)}q", *offsets))
        os.replace(tmp, bam_path + ".gidx")
        return True
    except (OSError, ValueError, struct.error):
        return False


def ensure_gidx(bam_path: str) -> bool:
    """True when <bam>.gidx exists (possibly just synthesized from an
    existing standard .bai)."""
    if os.path.exists(bam_path + ".gidx"):
        return True
    return gidx_from_bai(bam_path)
