from repro_torch.profiler.session import profile_step  # noqa: F401
