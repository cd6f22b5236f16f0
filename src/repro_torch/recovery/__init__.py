"""repro_torch.recovery — fault tolerance (port of ``repro/recovery``):
pre-generated departure templates (``templates``), simulated failures
(``failures``), the edge server's backups (``backup``) and recovery,
modeled and executed live on a Session (``recover``)."""
