"""gam_ngs_tpu_torch — the PyTorch/CUDA port of gam_ngs_tpu.

The same assembly reconciliation (gam create / merge / n50 / index),
with the device stages written for an NVIDIA Hopper GPU: the banded
Smith-Waterman forward fill (anti-diagonal and row form) and its
traceback walk are hand-written CUDA kernels (csrc/); the partition edge
count, create's block join (ops/device_join.py) and the multi-process
create's insert moments are torch ops.  Every kernel has a plain
PyTorch version beside it, which runs when its tensors lie on the CPU.
The package imports neither JAX nor gam_ngs_tpu: it keeps its own
copies of the host layers (io, core, graphs, merge, native, utils and
the exact oracles in ops).

Layout:
  device.py   --device name -> torch.device (no silent CPU fallback)
  _build.py   nvcc build of csrc/*.cu at first use, loaded with ctypes
  csrc/       the CUDA kernels
  ops/        kernel wrappers + plain versions, BswEngine and its host
              helpers, edge counter, device block join, exact oracles
  io/, core/  BAM/FASTA/blocks codecs, MultiBam, block construction
  graphs/     assembly / compact graphs, partition_blocks with the port's
              edge counter
  merge/      paths, forks, wavefront scheduler, alignment, weaving
  native/     the C++ BAM decoder, block scan and traceback walk (and
              its ThreadSanitizer harness)
  parallel/   torch.distributed runtime: multi-process merge and create
  utils/      metrics, C++-style number formatting
  models/     create / merge / n50 drivers
  cli.py      python -m gam_ngs_tpu_torch.cli {create,merge,n50,index}
"""

__version__ = "0.1.0"
