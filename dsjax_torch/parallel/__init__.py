"""Data-parallel training over torch.distributed: the process group
(``distributed``), host-side agreement between ranks (``multihost``) and
dsjax's mesh settings as checks (``mesh``)."""
