"""Quantitative evaluation of predict output."""
