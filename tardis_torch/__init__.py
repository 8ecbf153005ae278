"""tardis_torch: the PyTorch and CUDA port of tardis_tpu.

Same layout and names as ``tardis_tpu``; imports neither JAX nor
``tardis_tpu``.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  Five hand-written CUDA kernels (``csrc/``) carry the
classic path and the Type IIP continuum workflow
(``workflows/type_iip.py``): K1 ``transport_loop`` (transport/kernel.py;
its continuum branch serves the IIP workflow), K2 ``blackbody_source``
(transport/source.py), K3 ``line_tables`` (plasma/line_tables.py), K4
``vpacket_volley`` (transport/vpacket.py) and K5 ``formal_integral``
(spectrum/formal_integral.py); K1 and K4 are built once per combination
of transport options a run asks for.  Each has a plain PyTorch version
beside it, which runs only for CPU tensors.
"""
