"""cleverrec-tpu on PyTorch and CUDA.

The port of ``cleverrec_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100, one slice at a time; the JAX package stays the reference.  This
package imports torch and numpy, never JAX or the JAX package.  Its
entry points take a ``device``, default ``"cuda"``, and raise when no
card is present rather than run on the CPU.  The TPU kernels on a
slice's path are CUDA kernels written for Hopper (``csrc/``), each
beside a plain PyTorch version that CPU tensors take.
"""

__version__ = "0.1.0"

from cleverrec_tpu_torch.config import Config  # noqa: F401
