"""Numeric operations of the port: plain torch tensor code, plus the
wrappers of the hand-written CUDA kernels (ldpc.decoder, equalizer)."""
