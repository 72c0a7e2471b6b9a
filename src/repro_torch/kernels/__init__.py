"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, routed by the tensor's device (``kernels/dispatch.py``)."""
