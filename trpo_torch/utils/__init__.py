"""Utilities (counterpart: ``trpo_tpu/utils``)."""
