"""Live DP rows over padded rows (x_size against the chunk's window
bucket times its batch) of the align engine's chunks in the window:
BswEngine.util["rows_live"] / util["rows_padded"], the window's
difference."""


def read(run):
    if not run.util.get("rows_padded"):
        return None
    return 100.0 * run.util["rows_live"] / run.util["rows_padded"]
