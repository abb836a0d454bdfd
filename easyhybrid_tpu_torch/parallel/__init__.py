"""Multi-site modelling: one hybrid model lifted over a leading site axis."""

from .multisite import MultiSiteHybridModel, prepare_multisite_data

__all__ = ["MultiSiteHybridModel", "prepare_multisite_data"]
