"""tardis_torch: the PyTorch and CUDA port of tardis_tpu.

Same layout and names as ``tardis_tpu``; imports neither JAX nor
``tardis_tpu``.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the classic event loop splits its packets over every
visible card, or over a list of devices passed as ``device``
(``parallel/transport.py``).  Eight hand-written CUDA libraries
(``csrc/``) carry the port: K1 ``transport_loop`` (transport/kernel.py;
its continuum branch serves the Type IIP workflow), K2
``blackbody_source`` (transport/source.py), K3 ``line_tables``
(plasma/line_tables.py), K4 ``vpacket_volley`` (transport/vpacket.py), K5
``formal_integral`` (spectrum/formal_integral.py), K6 ``gamma_step``
(energy_input/gamma_kernel.py), K7 ``nonhom_loop``
(transport/nonhomologous.py), and ``probe2`` with the feasibility probe's
three kernels (benchmarks/probe2.py); K1, K4, K6 and K7 are built once per
combination of options a run asks for.  Each kernel has a plain PyTorch
version beside it, which runs only for CPU tensors.
"""
