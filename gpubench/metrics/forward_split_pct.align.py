"""Share of the window's live problems whose anti-diagonal forward ran a
split instance (each problem spread over several warps):
100 * BswEngine.util["fwd_split"] / util["live"], the window's
difference.  The forward's launcher takes the split instance where a
launch's batch leaves the card's schedulers empty; none where the engine
has no such counter or aligned nothing."""


def read(run):
    if "fwd_split" not in run.util or not run.util.get("live"):
        return None
    return 100.0 * run.util["fwd_split"] / run.util["live"]
