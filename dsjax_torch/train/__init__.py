"""Training: optimizer and state, metrics, logging, checkpoints, the loop.

``python -m dsjax_torch.train key=value ...`` runs ``dsjax_torch.workflows.train``.
"""
