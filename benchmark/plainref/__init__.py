"""The benchmark's plain reference encoder.

Plain PyTorch and NumPy that the benchmark holds the port's outputs to.
It imports nothing of the port (`nanohevc_tpu_torch`) nor of the JAX
package: `ops/`, `ref/`, `tables.py` and `params.py` are frozen copies
of the port's plain versions, `encoder.py` codes a batch of frames
through them, and `bitstream.py` writes the container, the mode coder
and the CABAC residual syntax in Python.
"""
