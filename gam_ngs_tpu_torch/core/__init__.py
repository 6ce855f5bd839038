from .multibam import MultiBam
from .stats import welford_isize_stats
