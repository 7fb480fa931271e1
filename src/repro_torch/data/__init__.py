from repro_torch.data.pipeline import DataPipeline, MarkovLM  # noqa: F401
