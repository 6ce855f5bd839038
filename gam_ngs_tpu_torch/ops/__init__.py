"""Device ops of the port: the CUDA kernel wrappers with their plain
PyTorch versions (bsw_antidiag, bsw_row, bsw_walk), the batched
banded-SW engine and its host helpers, the partition edge counter
(region_score), create's device block join (device_join), and the exact
host oracles (bsw_ref, fsw_ref, editops, ablast)."""
