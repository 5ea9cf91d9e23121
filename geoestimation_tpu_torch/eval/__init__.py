"""Evaluation: the f* rule, GCD metrics and the inference engine."""
