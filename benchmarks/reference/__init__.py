"""Plain PyTorch reference of the retrieval step the benchmark times.

It imports neither JAX, nor the JAX package, nor anything of the port: it
takes the inputs that ``benchmarks.synth`` makes and works out again what
the port derives from them (quantized caches, query scales).
"""
