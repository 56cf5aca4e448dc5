"""The plain reference that decides ``correct``.

NumPy and plain PyTorch, in FP32 with TF32 off unless a caller asks for
a lower precision (the control).  It imports neither JAX nor anything of
the port, and takes nothing that the port made: it splits the raw
interactions itself (``split``), rebuilds the graph, draws nothing, and
is handed only the benchmark's inputs (weights from the seed, the
sampler's draw it judges) and the port's outputs it judges.
"""
