"""Frozen copies of the port's numpy tables for deblocking and SAO."""
