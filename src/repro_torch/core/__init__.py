"""Step builders and federated averaging of the port (ports of
``repro.core.steps`` and ``repro.core.fedavg``)."""
