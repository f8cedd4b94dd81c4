"""CTC decoding (greedy only in this slice)."""
