"""DeepSpeech2 in PyTorch and its weight converters."""
