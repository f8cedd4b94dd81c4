"""Dataset preparation: download, unpack and convert a corpus, then write its manifests.

Copies of dsjax/datasets/ on the port's audio I/O and manifest code; each
corpus module runs as ``python -m dsjax_torch.datasets.<corpus>``.
"""
