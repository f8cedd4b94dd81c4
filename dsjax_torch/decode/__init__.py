"""CTC decoding: greedy, the device beam search (optionally with the n-gram
LM fused), and the host beam search with the LM."""
