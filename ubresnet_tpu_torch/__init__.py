"""ubresnet_tpu_torch — the PyTorch/CUDA port of ubresnet_tpu for one
NVIDIA H100.

The eval forward of the flagship UResNet runs on the card with its
high-resolution, low-channel end (stem pool, enc1, dec2, dec1, head)
on four hand-written Hopper kernels (ops/csrc/*.cu, built with nvcc
for sm_90a at first use and loaded with ctypes); every other layer is
a torch.nn.functional op. Each kernel keeps a plain PyTorch version
beside it, which is the CPU path and the kernel's oracle.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(utils/platform.py:resolve_device); with no card and no explicit CPU
request they raise.

larcv ROOT I/O (data/rootio.py) and the C++ batch filler
(data/native.py) bind the package's own cpp/rootio.cpp and cpp/uevt.cpp,
built with g++ at first use (utils/native_build.py).

The package imports torch and numpy only: never jax, never the JAX
package.
"""

__version__ = "0.1.0"

from ubresnet_tpu_torch.core.precision import Policy  # noqa: F401
