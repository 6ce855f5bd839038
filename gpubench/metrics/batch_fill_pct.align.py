"""Live problems over padded batch rows of the align engine's chunks in
the window: BswEngine.util["live"] / util["batch"], the window's
difference."""


def read(run):
    if not run.util.get("batch"):
        return None
    return 100.0 * run.util["live"] / run.util["batch"]
