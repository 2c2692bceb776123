"""Metrics and decision records used by the planner."""
