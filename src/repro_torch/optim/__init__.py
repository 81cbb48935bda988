"""Functional optimizers and learning-rate schedules."""
