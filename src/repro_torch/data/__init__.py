"""repro_torch.data — the synthetic driving data and its pod partitions
(numpy-only copies of the reference's modules, so both packages build
bit-equal datasets from the same seeds)."""
