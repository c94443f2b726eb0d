"""The port's version: the JAX package's (``kmunet_tpu/version.py``)."""

__version__ = "0.1.0"
