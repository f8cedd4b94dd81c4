"""Host audio I/O and STFT features (numpy/scipy; no torch, no jax)."""
