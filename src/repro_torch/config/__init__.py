"""Run configuration dataclasses."""
