"""Training data of the port (`repro.data`): the Morton token store and
its batch pipeline."""
from .pipeline import DataPipeline, PipelineConfig, TokenStore

__all__ = ["DataPipeline", "PipelineConfig", "TokenStore"]
