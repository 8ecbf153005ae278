"""tardis_torch: the PyTorch and CUDA port of tardis_tpu.

Same layout and names as ``tardis_tpu``; imports neither JAX nor
``tardis_tpu``.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  Three hand-written CUDA kernels (``csrc/``) carry the
classic convergence loop: K1 ``transport_loop`` (transport/kernel.py), K2
``blackbody_source`` (transport/source.py) and K3 ``line_tables``
(plasma/line_tables.py); each has a plain PyTorch version beside it, which
runs only for CPU tensors.
"""
