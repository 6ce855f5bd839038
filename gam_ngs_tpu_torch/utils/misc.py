"""Small host utilities mirroring the reference's UtilityFunctions.

Reference: lib/src/UtilityFunctions.cc
"""

import resource


def format_time(seconds: int) -> str:
    """Format seconds as the reference's formatTime (UtilityFunctions.cc:53)."""
    seconds = int(seconds)
    h = seconds // 3600
    m = (seconds % 3600) // 60
    s = (seconds % 3600) % 60
    out = ""
    if h > 0:
        out += f"{h}h"
    if m > 0:
        out += f"{m}m"
    out += f"{s}s"
    return out


def get_max_rss_kb() -> int:
    """Peak RSS in KiB (reference reads /proc status; getrusage is equivalent)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def max_rss_line(tag: str) -> str:
    """The reference binaries' exit line (src/gam-create.cc:51-65 with
    tag '[gam-create]', src/gam-merge.cc:51-65 with tag '[main]'):
    peak RSS scaled KB -> MB -> GB with the reference's exact cascade,
    printed fixed with 2 decimals."""
    maxrss = float(get_max_rss_kb())
    suff = "KB"
    if maxrss > 1024:
        maxrss /= 1024
        if maxrss <= 1024:
            suff = "MB"
        if maxrss > 1024:
            maxrss /= 1024
            suff = "GB"
    return f"{tag} MAX Memory used: {maxrss:.2f} {suff}"


def path_basename(path: str) -> str:
    """getPathBaseName (UtilityFunctions.cc:40)."""
    found = path.rfind("/")
    return path[found + 1:] if found != -1 else path
