"""PyTorch/CUDA port of `sr_for_cfd_tpu`: the SIMPLE finite-volume solver,
the super-resolution autoencoder and the hybrid workflow, with the JAX
package's TPU kernels rewritten as hand-written CUDA kernels (`csrc/`).

Imports `torch` and numpy only; the JAX package stays the reference.
Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`.
"""

__version__ = "0.1.0"
