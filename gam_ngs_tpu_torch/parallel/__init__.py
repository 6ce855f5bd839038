"""Multi-process merge and create over torch.distributed (gloo):
partition sharding, one-deadline collectives and the canonical-order
regather (distributed), the sharded block join and summed library
stats (create_dist)."""
