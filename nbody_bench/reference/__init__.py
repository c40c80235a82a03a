"""Plain float64 references, one module per law the configurations name.

They import torch and numpy and nothing of the program.
"""
