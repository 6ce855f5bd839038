from .cppfmt import cpp_double, cpp_float
from .misc import format_time, get_max_rss_kb
