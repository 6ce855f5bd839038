"""Multi-process merge over torch.distributed (gloo): partition sharding,
one-deadline collectives and the canonical-order regather."""
