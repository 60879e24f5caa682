"""avion_tpu_torch: the PyTorch / CUDA (H100) port of ``avion_tpu``.

A package of its own beside the JAX one: it imports ``torch`` and never
``jax`` or anything of ``avion_tpu``.  Every Pallas kernel of the JAX
package on a ported path becomes a CUDA C++ kernel for ``sm_90a`` under
``ops/csrc``, built at first use.  Entry points run on CUDA unless the
caller passes ``--device cpu``.
"""

__version__ = "0.1.0"
