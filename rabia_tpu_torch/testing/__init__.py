"""Test harnesses of the port: the engine-level plane-conformance gate
(:mod:`rabia_tpu_torch.testing.conformance`)."""
