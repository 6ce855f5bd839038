"""BGZF (blocked gzip) codec.

BAM containers are BGZF streams: concatenated gzip members, each at most
64 KiB of uncompressed payload, carrying a BSIZE extra field, terminated
by a fixed 28-byte EOF member (SAM spec §4.1).  Python's zlib handles
the member framing for us on read; on write we produce spec-compliant
blocks so that external tools (samtools, the reference binaries) can
read our test files.

Replaces the vendored BamTools BGZF layer of the reference
(lib/bamtools-2.3.0/src/api/internal/io/BgzfStream_p.cpp).
"""

from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_MAX_PAYLOAD = 65280  # keep compressed block < 65536


def decompress(data: bytes) -> bytes:
    """Decompress a whole BGZF (multi-member gzip) byte string."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        d = zlib.decompressobj(wbits=zlib.MAX_WBITS | 16)
        out.append(d.decompress(data[pos:]))
        consumed = n - pos - len(d.unused_data)
        if consumed <= 0:
            break
        pos += consumed
    return b"".join(out)


def read_file(path: str) -> bytes:
    with open(path, "rb") as fh:
        return decompress(fh.read())


def _one_block(payload: bytes) -> bytes:
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    bsize = len(cdata) + 25 + 1  # header(12) + extra(6) + cdata + crc(4) + isize(4)
    header = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 0x08, 0x04,  # gzip magic, deflate, FEXTRA
        0,                        # mtime
        0, 0xFF,                  # xfl, os
        6,                        # xlen
        0x42, 0x43,               # 'B' 'C'
        2,                        # subfield length
        bsize - 1,                # BSIZE - 1
    )
    return header + cdata + struct.pack("<II", zlib.crc32(payload), len(payload))


def compress(data: bytes, with_eof: bool = True) -> bytes:
    """Compress bytes into a BGZF stream (+ EOF marker)."""
    blocks = [
        _one_block(data[i:i + _MAX_PAYLOAD]) for i in range(0, len(data), _MAX_PAYLOAD)
    ]
    if not data:
        blocks = []
    if with_eof:
        blocks.append(BGZF_EOF)
    return b"".join(blocks)


def write_file(path: str, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(compress(data))
