"""BAM-list text format.

Reference: loadBamFileNames (lib/src/UtilityFunctions.cc:67):
alternating lines — a BAM path, then a "min max" insert-bound line (an
empty line, or unparsable text, yields 0 0).
"""

from __future__ import annotations


def load_bam_file_names(path: str) -> tuple[list[str], list[int], list[int]]:
    names: list[str] = []
    min_insert: list[int] = []
    max_insert: list[int] = []
    with open(path) as fh:
        lines = fh.read().split("\n")
    i = 0
    while i < len(lines):
        line1 = lines[i].strip()
        i += 1
        if line1 == "":
            continue
        names.append(line1)
        line2 = lines[i] if i < len(lines) else ""
        i += 1
        mn = mx = 0
        parts = line2.split()
        try:
            if len(parts) >= 1:
                mn = int(parts[0])
            if len(parts) >= 2:
                mx = int(parts[1])
        except ValueError:
            mn, mx = 0, 0
        min_insert.append(mn)
        max_insert.append(mx)
    return names, min_insert, max_insert
