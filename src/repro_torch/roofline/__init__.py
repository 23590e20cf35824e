"""Roofline model of a step on one H100 (port of ``repro.roofline``)."""
