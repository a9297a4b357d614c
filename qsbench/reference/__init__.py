"""Plain PyTorch references for qsbench's correctness checks.

They import torch and NumPy only: nothing of the program under test and
nothing of the JAX package. A test parses their imports to hold that.
"""
