"""Band cells (x_size x (2*band+1), from the benchmark's own problems) of
every round finished in the window, over the window, in 1e9 a second."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.cells / run.window_s / 1e9
