"""Multi-device rendering over torch.distributed (parallel/multichip.py): the
port of the JAX package's ('rows', 'tri') device mesh, one process a rank.
"""
