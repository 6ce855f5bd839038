"""The least time the card could take for the window's align work (the
larger of its int32 operations over the card's int32 rate and its
bytes over the memory rate, peaks.align_bound_s, counted from the
problems and their answers), over the summed device time of every
kernel in the traced window."""

from gpubench import peaks


def read(run):
    if run.trace is None or run.trace.kernel_s <= 0:
        return None
    bound_s, _ = peaks.align_bound_s(run.rows, run.problems,
                                     run.walk_steps, run.band)
    return 100.0 * bound_s / run.trace.kernel_s
