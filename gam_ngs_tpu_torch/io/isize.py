""".isize statistics file codec.

Reference: MultiBamReader::writeStatsToFile / readStatsFromFile
(lib/src/bam/MultiBamReader.cc:532-581).  Per library:

    <bam filename>
    <isize_mean>\\t<isize_std>\\t<coverage>

Doubles use C++ ostream default formatting (%.6g).
"""

from __future__ import annotations

from ..utils.cppfmt import cpp_double


def write_isize(path: str, filenames: list[str], means, stds, coverages) -> None:
    with open(path, "w") as fh:
        for fn, m, s, c in zip(filenames, means, stds, coverages):
            fh.write(fn + "\n")
            fh.write(f"{cpp_double(m)}\t{cpp_double(s)}\t{cpp_double(c)}\n")


def read_isize(path: str, expected_filenames: list[str]):
    """Returns (means, stds, coverages); validates filenames like the reference."""
    means, stds, covs = [], [], []
    with open(path) as fh:
        lines = [ln for ln in fh.read().split("\n")]
    idx = 0
    i = 0
    while i < len(lines):
        bamfile = lines[i]
        i += 1
        if bamfile == "":
            continue
        if idx >= len(expected_filenames):
            break
        if bamfile != expected_filenames[idx]:
            raise ValueError(
                f"[bam] Error loading libraries statistics file "
                f"(corresponding BAM file not found).\n      {bamfile}"
            )
        data = lines[i] if i < len(lines) else ""
        i += 1
        parts = data.split()
        vals = [0.0, 0.0, 0.0]
        for k in range(min(3, len(parts))):
            try:
                vals[k] = float(parts[k])
            except ValueError:
                break
        means.append(vals[0])
        stds.append(vals[1])
        covs.append(vals[2])
        idx += 1
    return means, stds, covs
