"""Walk steps over the walk's iterations in the align engine's chunks of
the window: BswEngine.util["walk_steps"] / util["walk_iters"], the
window's difference.  The find-max + walk kernel takes a diagonal run of
up to 32 word rows in one iteration and every other step in one each,
so this reads how much of the walk went by runs; none where the engine
counts no iterations."""


def read(run):
    if not run.util.get("walk_iters"):
        return None
    return run.util["walk_steps"] / run.util["walk_iters"]
