"""graphite_tpu_torch — the many-core timing simulator on PyTorch and CUDA.

A second implementation of the ``graphite_tpu`` engine, written with
PyTorch tensors and hand-written CUDA kernels for NVIDIA Hopper.  It reads
the same carbon_sim-style config and the same trace files, builds the same
``SimState`` leaves, and must end every run bit-identical to the JAX
package: the engine is all-integer picoseconds, so "the same" means equal
on every leaf and every round counter.

The package imports ``torch`` and numpy only.  Entry points take a
``device``; ``None`` means CUDA, and with no GPU present that raises
instead of falling back to the CPU.  Pass ``device="cpu"`` to run the
plain PyTorch forms of the kernels on the host.
"""

__version__ = "0.1.0"

from graphite_tpu_torch.config import Config, ConfigError, load_config  # noqa: E402,F401
