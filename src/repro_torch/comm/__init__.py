"""repro_torch.comm — the event queue the serving load generator runs on
(the FL communication fabric is not ported yet)."""
