"""The 95th percentile of a whole align stage's time (every round of one
merge, host clock, each round ended by a synchronize), over every stage
finished in the window; none below 20 stages."""

import numpy as np


def read(run):
    if len(run.stage_s) < 20:
        return None
    return float(np.percentile(np.asarray(run.stage_s) * 1e3, 95))
