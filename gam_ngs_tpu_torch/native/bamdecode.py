"""Adapter: native gamio decoder -> io.bam table types."""

from __future__ import annotations

from .loader import native_available, read_bam_native


def available() -> bool:
    return native_available()


def decode_file(path: str, ref_range: tuple[int, int] | None = None,
                index_path: str | None = None):
    if ref_range is None:
        res = read_bam_native(path, index_path=index_path)
    else:
        res = read_bam_native(path, ref_lo=ref_range[0],
                              ref_hi=ref_range[1], index_path=index_path)
    if res is None:
        raise ImportError("native gamio library unavailable")
    text, names, lengths, cols = res
    from ..io.bam import AlignmentTable, BamHeader

    return BamHeader(text, names, lengths), AlignmentTable(**cols)


def build_index(path: str) -> bool:
    """Full scan writing <path>.gidx; False if the native lib is absent."""
    res = read_bam_native(path, index_path=path + ".gidx")
    return res is not None
