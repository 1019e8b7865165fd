"""Drivers: one module per kind of traffic, each with a ``Cell`` class."""
