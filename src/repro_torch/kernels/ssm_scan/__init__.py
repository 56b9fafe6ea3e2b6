from repro_torch.kernels.ssm_scan.scan import selective_scan  # noqa: F401
