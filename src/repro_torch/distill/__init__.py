"""repro_torch.distill — LoRA adapters (:mod:`~repro_torch.distill.lora`),
the AD-LLM view of the edge model (:mod:`~repro_torch.distill.celladapt`)
and federated personalized distillation
(:mod:`~repro_torch.distill.federated`), the ``distill_fl`` strategy's
round."""
