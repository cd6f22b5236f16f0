"""repro_torch.sched — the vehicle fleet model the serving load generator
needs (the SWIFT scheduler is not ported yet)."""
