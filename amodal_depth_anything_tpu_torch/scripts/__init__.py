"""Evaluation scripts of the port (`zero_shot_eval`, `precomputed_eval`)."""
