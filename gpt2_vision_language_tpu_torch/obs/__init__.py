from .csvlog import MetricsLogger

__all__ = ["MetricsLogger"]
