"""The checkpointable synthetic data pipeline."""
from .pipeline import DataState, SyntheticPipeline

__all__ = ["DataState", "SyntheticPipeline"]
