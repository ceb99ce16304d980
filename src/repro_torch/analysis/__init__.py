"""Roofline terms and collective traffic of a step, counted as it runs."""
