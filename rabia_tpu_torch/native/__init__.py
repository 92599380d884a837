"""The port's native host plane: the C++ TCP transport, codec, host kernel,
state kernel and GIL-free runtime, built with g++ at first use
(:mod:`rabia_tpu_torch.native.build`) and bound through ctypes.
"""

from rabia_tpu_torch.native.build import library_path, load_library

__all__ = ["library_path", "load_library"]
