"""Native (C++) host-data-plane components, loaded via ctypes.

The hot streaming paths of the framework — BGZF inflation and BAM
record parsing (the reference's BamTools layer) — are implemented in
gamio.cc and built on first use with the system toolchain.  Pure-Python
oracles live in the io package and remain the behavioural reference;
everything native is parity-tested against them.
"""

from .loader import native_available, read_bam_native
