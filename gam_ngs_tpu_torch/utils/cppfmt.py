"""C++ iostream-compatible number formatting.

The reference emits doubles with `std::ostream` default formatting
(defaultfloat, precision 6), e.g. in `.isize` files
(lib/src/bam/MultiBamReader.cc:539) and graphviz edge
labels.  That is byte-identical to printf("%.6g") modulo exponent digits,
which glibc prints identically ("1e+06").
"""


def cpp_double(x: float) -> str:
    """Format a double exactly like C++ `os << x` with default flags."""
    if x != x:  # NaN
        return "nan" if str(x)[0] != "-" else "-nan"
    if x == float("inf"):
        return "inf"
    if x == float("-inf"):
        return "-inf"
    s = "%.6g" % x
    # glibc prints at least two exponent digits, as does Python: "1e+06".
    return s


def cpp_float(x: float) -> str:
    """Same as cpp_double — ostream precision is 6 for float too."""
    return cpp_double(x)
