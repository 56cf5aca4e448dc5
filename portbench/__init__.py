"""The benchmark of the PyTorch and CUDA port (``cleverrec_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; ``harness`` finds the
cell's configuration, traffic mix, metrics and limits by name; ``kinds``
drives the port; ``reference/`` is the plain reference that decides
``correct``; ``calibrate.py`` takes the readings the limits are set
from.  Nothing here imports JAX or the JAX package.
"""
