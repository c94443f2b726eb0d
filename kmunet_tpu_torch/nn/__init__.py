"""Layers of the port, as ``torch.nn`` modules on NCHW tensors.

Submodule and parameter names mirror the flax module names of the JAX
package, so ``kmunet_tpu_torch.convert`` maps a flax path to a state_dict key
by joining it with dots and renaming the leaf.
"""
