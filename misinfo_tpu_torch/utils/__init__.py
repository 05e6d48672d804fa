from misinfo_tpu_torch.utils.tracing import stage_timer, Tracer  # noqa: F401
