"""Multi-device training over torch.distributed: the process group
(``distributed``), host-side agreement between ranks (``multihost``),
dsjax's mesh as model and data groups (``mesh``) and the sharding of the
recurrent and head weights over a model group (``tensor``)."""
