from repro_torch.serving.engine import Request, ServeConfig, ServingEngine  # noqa: F401
