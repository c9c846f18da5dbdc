"""PyTorch / CUDA port of the event-dataframe process-mining system.

A package of its own beside the JAX package ``repro``: it imports neither
JAX nor ``repro``.  Entry points run on the card (``device="cuda"``) unless
the caller names the CPU; the DFG path's counting primitives are
hand-written CUDA kernels for Hopper (``kernels/csrc``).
"""
