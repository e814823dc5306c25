"""repro_torch — the PyTorch / CUDA port of the pipelined parallel MCTS.

Laid out file for file like the JAX package ``repro``: ``core`` (arena,
tree, UCT scoring, stages, domains), ``kernels`` (hand-written CUDA kernels
for Hopper under ``csrc/``, each with its plain PyTorch version) and
``search`` (the public API).  It imports neither JAX nor ``repro``.
"""
