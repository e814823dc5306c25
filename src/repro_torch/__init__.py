"""repro_torch — the PyTorch / CUDA port of the pipelined parallel MCTS.

Laid out file for file like the JAX package ``repro``: ``core`` (arena,
tree, UCT scoring, stages, domains), ``kernels`` (hand-written CUDA kernels
for Hopper under ``csrc/``, each with its plain PyTorch version),
``search`` (the public API, its sharded and fault-tolerant forms),
``models``, ``serving``, ``parallel`` (search meshes over devices and
processes), ``checkpoint`` and ``runtime`` (the fault-tolerant loop,
straggler policy, elastic shrink).  It imports neither JAX nor
``repro``.
"""
