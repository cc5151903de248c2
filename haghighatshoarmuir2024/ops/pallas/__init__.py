"""Pallas GPU kernels for the time-sequential hot loops."""

from .lif_kernel import lif_count_rates

__all__ = ["lif_count_rates"]
