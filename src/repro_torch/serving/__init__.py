"""Serving for the port's LM substrate (one device)."""

from repro_torch.serving.engine import ServeConfig, ServeEngine, ServeStats

__all__ = ["ServeConfig", "ServeEngine", "ServeStats"]
