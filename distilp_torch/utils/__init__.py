"""Utilities of the port: synthetic fleets."""

from .synthetic import make_synthetic_fleet, stretch_model_for_fleet

__all__ = ["make_synthetic_fleet", "stretch_model_for_fleet"]
