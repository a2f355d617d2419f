"""Prompt datasets for RL rollout (the slice's part of
``areal_tpu/datasets``)."""
