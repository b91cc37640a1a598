"""PyTorch + CUDA port of the Dynamic Exploration Graph (DEG).

The layout mirrors ``src/repro/``: ``core/`` (graph, metrics, visited set,
beam engine, range search, construction), ``quant/`` (the vector store),
``kernels/<name>/{ops,ref}.py`` with CUDA C++ sources under
``kernels/csrc/``.  Every entry point takes a ``device`` that defaults to
``"cuda"``; a CPU tensor takes each kernel's plain PyTorch version.
"""
