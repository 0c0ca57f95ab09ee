from repro_torch.data.pipeline import SyntheticTokenPipeline  # noqa: F401
