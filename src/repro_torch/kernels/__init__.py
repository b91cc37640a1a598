"""Hand-written CUDA C++ kernels for Hopper (``sm_90a``), one package per
TPU kernel of ``src/repro/kernels/``: ``<name>/ops.py`` dispatches (a CUDA
tensor launches the kernel, a CPU tensor takes the plain version) and
counts launches, ``<name>/ref.py`` is the plain PyTorch version, and
``csrc/<name>.cu`` the kernel, built by ``_build.py`` at first use.

Kernels: ``beam_search`` (a whole range search, over every store),
``fused_hop``, ``beam_merge`` and ``gather_dist`` (the host loop's hop),
``gather_dist_q`` and ``pq_adc`` (its hop over the compressed stores),
``extend_select`` (the extension's selection pass), ``mrng_occlusion``
(refinement's conformity test), ``l2_topk`` (the brute-force scan) and
``bag_lookup`` (the recsys embedding bag).  Nothing is built at import.
"""
